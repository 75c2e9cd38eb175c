"""Launch geometry of both attention kernels at every head shape the
ported decoder configs have, without a card.

``decode_geometry`` and ``prefill_geometry`` choose each CTA's
shared-memory plan (warps, ring stages, the staged query tile) from the
head shape; the CUDA sources compute the same bytes and refuse a launch
that does not fit.  These tests pin what the kernels need to launch: at
most ``MAX_SMEM_BYTES`` of dynamic shared memory and at least one
resident CTA an SM, at stablelm-3b's, gemma2-2b's, deepseek-coder-33b's,
nemotron-4-340b's, recurrentgemma-2b's, granite-moe-3b-a800m's (H 24 /
Hkv 8 / Dh 64: G = 3) and grok-1-314b's (H 48 / Hkv 8 / Dh 128: G = 6)
head shapes over bf16, int8 and f32 pools (bs = 16, B = 8, W = 32,
prefill S = 128), and across Dh in {64, 80, 128, 192, 256} and G in
{1, 2, 3, 6, 7, 10, 12}.  stablelm-3b's plan stays
the one measured before (four warps of two stages; 84296 and 45384
bytes).  recurrentgemma-2b's MQA head (H 10, Hkv 1, Dh 256: G = 10 query
rows on one K/V head) splits each slot's keys four ways, so decode at
B = 8 launches Hkv·B·split = 32 CTAs.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import prefill_attention as PF

ARCHS = ["stablelm-3b", "gemma2-2b", "deepseek-coder-33b", "nemotron-4-340b",
         "recurrentgemma-2b", "granite-moe-3b-a800m", "grok-1-314b"]
POOLS = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}


def _check(h, hkv, dh, kv):
    geo = PA.decode_geometry(8, h, hkv, dh, 16, 32, kv)
    assert geo["smem_bytes"] <= PA.MAX_SMEM_BYTES and geo["ctas_per_sm"] >= 1, geo
    assert geo["threads"] == 32 * geo["warps"] and geo["rows"] == h // hkv
    # the bf16 route of a bf16 or int8 pool, the f32 route of an f32 one
    qdt = torch.float32 if kv == torch.float32 else torch.bfloat16
    pre = PF.prefill_geometry(128, h, hkv, dh, 16, qdt, kv)
    assert pre["smem_bytes"] <= PA.MAX_SMEM_BYTES and pre["ctas_per_sm"] >= 1, pre
    if qdt == torch.bfloat16:
        assert dh in PF.TC_HEAD_DIMS and pre["route"] == "tensor-core"
    return geo, pre


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_head_shape_launches(arch, pool):
    cfg = get_config(arch)
    geo, pre = _check(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, POOLS[pool])
    if arch == "stablelm-3b" and pool != "f32":
        assert (geo["warps"], geo["stages"]) == (4, 2)
        assert geo["smem_bytes"] == {"bf16": 84296, "int8": 45384}[pool]
        assert geo["n_split"] == {"bf16": 1, "int8": 2}[pool]
        assert pre["warps"] == PF.TC_WARPS


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("g", [1, 2, 3, 6, 7, 10, 12])
@pytest.mark.parametrize("dh", [64, 80, 128, 192, 256])
def test_head_dims_and_groups_launch(dh, g, pool):
    _check(8 * g, 8, dh, POOLS[pool])


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("hkv", [1, 2])
def test_mqa_group_of_ten_launches(hkv, pool):
    """G = 10 at Hkv 1 (recurrentgemma-2b's head) and 2, Dh 256: the
    decode plan splits each slot's keys four ways at B = 8, the grid holds
    Hkv·B·split CTAs (32 at Hkv 1), and the bf16 and int8 pools' prefill
    takes the tensor-core tile, as the f32 pool's takes the CUDA-core
    route."""
    geo, pre = _check(10 * hkv, hkv, 256, POOLS[pool])
    assert geo["rows"] == 10 and geo["n_split"] == 4
    assert geo["grid"][0] * geo["grid"][1] * geo["grid"][2] == hkv * 8 * geo["n_split"]
    assert pre["route"] == ("cuda-core" if pool == "f32" else "tensor-core")
