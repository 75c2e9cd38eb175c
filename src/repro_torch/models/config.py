"""Unified model configuration, copied field for field from
``repro/models/config.py`` so a config built for one package reads the
same in the other.  Family-specific fields default to inert values; the
port runs the ``decoder_lm``, ``moe_lm``, ``hybrid``, ``ssm`` and ``vlm``
families (serving and training), ``encdec`` (the dense serve step and
training) and ``fcnn``, the paper's network (training and RACA
inference).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.analog import DIGITAL, AnalogConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # decoder_lm | moe_lm | ssm | hybrid | encdec | vlm | fcnn

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab: int = 0
    max_seq: int = 8192

    mlp: str = "swiglu"            # swiglu | geglu | gelu | relu2
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    embed_scale: bool = False       # gemma-style sqrt(d_model) embed scaling

    # Attention pattern: repeating unit of layer kinds, e.g. gemma2's
    # ("local", "global") or recurrentgemma's ("rec", "rec", "attn").
    layer_pattern: Tuple[str, ...] = ("global",)
    local_window: int = 4096
    attn_softcap: float = 0.0       # gemma2 logit soft-capping inside attn
    logit_softcap: float = 0.0      # gemma2 final-logit soft-capping
    post_norms: bool = False        # gemma2 post-block norms

    # MoE
    n_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # Recurrent (RG-LRU)
    lru_width: int = 0

    # Encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0
    enc_seq: int = 0                # fixed encoder length for decode shapes

    # VLM
    n_patches: int = 0              # prepended patch-embedding tokens

    # FCNN (the paper's network)
    fcnn_layers: Tuple[int, ...] = ()

    # Analog (RACA) execution
    analog: AnalogConfig = DIGITAL
    wta_head: bool = False          # WTA stochastic SoftMax readout

    # Performance knobs (hillclimbed in EXPERIMENTS.md §Perf)
    dtype: str = "bfloat16"
    remat_policy: str = "nothing"   # nothing | dots | full  (what to SAVE)
    scan_layers: bool = True
    scan_unroll: int = 1
    attn_probs_dtype: str = "float32"  # float32 | bfloat16 (scores/probs)
    attn_kv_chunk: int = 1024          # online-softmax KV chunk length
    # Pad query heads to this count (0 = off) so "model" divides the head
    # axis; padded heads' outputs are sliced away before w_o (numerically
    # identity, enables 16-way sharding of otherwise-replicated attention).
    attn_pad_heads: int = 0
    # Repeat KV heads up to n_heads before attention (GQA -> MHA layout) so
    # the flattened head axis shards; trades kv bytes for score sharding.
    gqa_repeat_kv: bool = False
    kv_cache_dtype: str = "same"       # same | int8 (stochastic-rounded)
    # cost_exact: fully unroll every lax.scan so XLA cost_analysis counts all
    # iterations (it otherwise counts a loop body ONCE).  Used by the
    # dry-run's roofline pass; compile-only, never executed.
    cost_exact: bool = False
    # force_fsdp: pin the FSDP decision (normally param_count-derived) so
    # reduced-layer cost-pass compiles keep the full model's sharding.
    force_fsdp: Optional[bool] = None

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def n_units(self) -> int:
        """Number of repeating pattern units (scanned)."""
        p = len(self.layer_pattern)
        assert self.n_layers % p == 0, (self.n_layers, self.layer_pattern)
        return self.n_layers // p

    def param_count(self) -> int:
        """Approximate parameter count N (for roofline MODEL_FLOPS=6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.mlp in ("swiglu", "geglu"):
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe_lm":
            mlp = mlp * self.n_experts + d * self.n_experts
        if self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            nh = self.ssm_nheads
            per = d * (2 * di + 2 * ns + nh) + di * d + di  # in/out proj + Δ
            layers = self.n_layers * per
        elif self.family == "hybrid":
            per_attn = attn + mlp
            di = self.lru_width or d
            per_rec = d * di * 2 + di * d + 2 * di * di // 8 + mlp  # approx
            n_attn = self.n_layers // 3
            layers = per_attn * n_attn + per_rec * (self.n_layers - n_attn)
        elif self.family == "encdec":
            layers = (self.enc_layers + self.dec_layers) * (attn + mlp)
            layers += self.dec_layers * attn  # cross-attention
        elif self.family == "fcnn":
            return sum(
                a * b + b
                for a, b in zip(self.fcnn_layers[:-1], self.fcnn_layers[1:])
            )
        else:
            layers = self.n_layers * (attn + mlp)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return layers + embed

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe_lm":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.mlp in ("swiglu", "geglu") else 2) * d * f
        inactive = (self.n_experts - self.moe_topk) * per_expert
        return self.param_count() - self.n_layers * inactive
