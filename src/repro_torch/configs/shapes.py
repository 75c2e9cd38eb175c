"""Assigned input-shape suite (LM-family: seq_len x global_batch), as in
``repro/configs/shapes.py``.

``decode_*`` / ``long_*`` are serve-step shapes (one new token against a
KV cache of seq_len), not training shapes.  ``long_500k`` requires
sub-quadratic attention: it runs only for ssm/hybrid archs.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
