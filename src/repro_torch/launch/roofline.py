"""Roofline terms of a dry-run cell (``repro/launch/roofline.py``),
against one H100's data-sheet peaks:

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The dry run counts, on rank 0 of the DTensor mesh, FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
convolutions and attention only: the reference's XLA ``cost_analysis``
counts every op), bytes as every op's operands and results, unfused, and
collective bytes over the ``_c10d_functional`` ops the step issues, by the
reference's formula (all-gather: the result; reduce-scatter: the
operand; all-reduce: twice the operand; all-to-all and permute: the
operand).  They replace the reference's HLO parser
(``parse_collectives``): the port has no HLO.  A record from before the
mesh terms has ``collectives`` ``None``: no collective term, and its
dominant term is chosen between compute and memory.
"""

from __future__ import annotations

# H100 SXM 80GB HBM3, data sheet, 700 W: bf16 dense tensor-core FLOP/s
PEAK_FLOPS = 989e12
# H100 SXM 80GB HBM3, data sheet, 700 W: HBM3 bytes/s
HBM_BW = 3.35e12
# H100 SXM 80GB HBM3, data sheet, 700 W: NVLink bytes/s each way (900 GB/s both)
LINK_BW = 450e9
# H100 SXM 80GB HBM3, data sheet, 700 W: HBM bytes
HBM_PER_DEVICE = 80e9

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                   "collective-permute")


def model_flops(cfg, shape) -> float:
    """Useful FLOPs per step (global): 6·N·D train, 2·N·D forward-only;
    MoE uses active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            d = shape.global_batch * (shape.seq_len + 448)
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch  # decode: one token


def roofline_terms(record: dict) -> dict:
    """record: one dry-run cell (see dryrun.py)."""
    flops_pd = record["cost"].get("flops", 0.0)
    bytes_pd = record["cost"].get("bytes accessed", 0.0)
    colls = record.get("collectives")
    t_c = flops_pd / PEAK_FLOPS
    t_m = bytes_pd / HBM_BW
    terms = [(t_c, "compute"), (t_m, "memory")]
    t_x = None
    if colls is not None:
        t_x = colls["total_bytes"] / LINK_BW
        terms.append((t_x, "collective"))
    # key= compares times only, so ties resolve in the listed order:
    # compute, then memory, then collective
    dom = max(terms, key=lambda t: t[0])[1]
    bound = max(t for t, _ in terms)
    mf = record["model_flops_per_chip"]
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "dominant": dom,
        "useful_flops_ratio": (mf / flops_pd) if flops_pd else 0.0,
        "bound_s": bound,
        # useful work over the time the dominant term costs
        "roofline_fraction": (mf / PEAK_FLOPS) / bound if bound > 0 else 0.0,
    }


def improvement_hint(record: dict, ro: dict) -> str:
    """One sentence: what would move the dominant term down."""
    kind = record.get("kind", "train")
    dom = ro["dominant"]
    ufr = ro["useful_flops_ratio"]
    coll = record.get("collectives") or {}
    if dom == "compute":
        if ufr < 0.5:
            return ("compute is mostly remat/replication waste — relax the "
                    "remat policy or shard the replicated attention heads")
        return ("near-useful-compute bound — raise arithmetic intensity "
                "(larger per-chip batch) or accept")
    if dom == "memory":
        if kind == "decode":
            return ("decode reads the whole KV cache per token — shrink "
                    "local-window caches / quantize KV to int8")
        return ("activation traffic dominates — chunk the f32 logits/CE, "
                "save dots instead of recomputing (remat policy)")
    big = max(COLLECTIVE_OPS, key=lambda k: coll.get(k, 0))
    return (f"{big} dominates — overlap it with compute, reduce its "
            "precision (int8/bf16), or reshard to keep it on-pod")
