"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
``repro/models/rglru.py``).

Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)              (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)              (input gate)
    a_t = a^(c·r_t),  a = sigmoid(Λ)          (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The block wraps the RG-LRU with a causal width-4 temporal conv and a GeLU
gate branch, as in Griffin.  In ``analog_stochastic`` mode both sigmoid
gates are the paper's comparator-sampled binary neuron
(``neurons.sigmoid_neuron_calibrated``: one ``ops.sigmoid_sample`` launch
per gate, the hand-written kernel on the card).

The scan and the conv have no Pallas kernel in the reference (they are
jnp code), so plain PyTorch is their path on every device.
:func:`rglru_scan` mirrors ``jax.lax.associative_scan``'s odd/even
recursion, so the products and sums of the linear recurrence are formed
in the reference's order; ``exp``, ``sqrt``, ``sigmoid`` and the tanh
``gelu`` are torch's, a few ulps from XLA's, so hidden states and logits
agree to a tolerance, not bit for bit.

Numerics kept from the reference: the conv accumulates in f32 and a zero
``conv_cache`` is exactly the zero pad; :func:`rglru_prefill` IS
:func:`rglru_prefill_chunk` from a zero carry (the dense-vs-paged identity
rests on it); the decode step rounds the conv output through the
activation dtype, as the prefill's conv output is rounded; ``ba``, ``bx``
and ``lam`` are f32 leaves in a bf16 model, and the gate weights ``wa``
and ``wx`` are cast to f32 at every call (the cast is exact), the
reference's choice, so no f32 copy of them is kept.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import parallel as PX
from repro_torch import random as R
from repro_torch.core import analog as A
from repro_torch.core import neurons
from .config import ModelConfig
from .layers import dtype_of, normal_init, randn

_C_EXP = 8.0
CONV_WIDTH = 4


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int] = ()) -> dict:
    """Seeded parameters with the reference's leaves, shapes and dtypes
    (``lead`` is the stacked units' axis)."""
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = dtype_of(cfg)
    lead = tuple(lead)
    dev = gen.device
    conv_w = randn(gen, lead + (CONV_WIDTH, w)) * 0.1

    def f32(values: torch.Tensor) -> torch.Tensor:
        return values.to(torch.float32).expand(lead + (w,)).clone()

    return {
        "w_main": normal_init(gen, lead + (d, w), d, dt),      # branch 1 -> conv -> RG-LRU
        "w_gate_br": normal_init(gen, lead + (d, w), d, dt),   # branch 2 -> GeLU
        "w_out": normal_init(gen, lead + (w, d), w, dt),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros(lead + (w,), dtype=dt, device=dev),
        "wa": normal_init(gen, lead + (w, w), w, dt),          # recurrence gate
        "wx": normal_init(gen, lead + (w, w), w, dt),          # input gate
        "ba": f32(torch.full((w,), 2.0, device=dev)),
        "bx": f32(torch.zeros((w,), device=dev)),
        "lam": f32(torch.linspace(2.0, 5.0, w, device=dev)),  # a = σ(Λ)
    }


def _conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          cache: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal conv of u (B, S, W) with taps w (K, W), accumulated in f32
    tap by tap and rounded to u's dtype.  ``cache`` (B, K-1, W), when
    given, replaces the zero left pad with the conv inputs preceding the
    chunk; a zero cache gives exactly the zero pad."""
    k = w.shape[0]
    uf = u.float()
    if cache is None:
        pad = F.pad(uf, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([cache.float(), uf], dim=1)
    s = u.shape[1]
    out = torch.zeros_like(uf)
    wf = w.float()
    for i in range(k):
        out = out + pad[:, i : i + s, :] * wf[i]
    return (out + b.float()).to(u.dtype)


def _combine(c1: tuple, c2: tuple) -> tuple:
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows even[0], odd[0], even[1], ... along axis 1."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty(even.shape[:1] + (n,) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(elems: tuple) -> tuple:
    """``jax.lax.associative_scan(_combine, elems, axis=1)``: the same
    odd/even recursion, so every product and sum is formed from the same
    operands in the same order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[:, 0 : n - 1 : 2] for e in elems),
                       tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine(tuple(e[:, :-1] for e in odd), tuple(e[:, 2::2] for e in elems))
    else:
        even = _combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def rglru_scan(x: torch.Tensor, log_a: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t over axis 1 for x, log_a (B, S, W) f32
    (log_a < 0), from ``h0`` (B, W) or zero; returns every h (B, S, W).
    On a mesh the scan runs on each rank's rows and width
    (``parallel.along``)."""
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * x
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return PX.along(lambda a, b: _associative_scan((a, b))[1], 1, a, b)


def _log_a_unit(p: dict) -> torch.Tensor:
    """log σ(Λ) = −softplus(−Λ) < 0, per channel."""
    return -F.softplus(-p["lam"])


def _gate_logits(p: dict, mf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence and input gates' pre-activations, in f32."""
    return mf @ p["wa"].float() + p["ba"], mf @ p["wx"].float() + p["bx"]


def rglru_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, key=None) -> torch.Tensor:
    """The block over a whole sequence x (B, S, D), the training path's.
    In the analog modes the input projections run the crossbar under keys
    ``split(key, 4)[0:2]`` (``analog_linear``: ``analog_stochastic``
    projects linearly), and under ``analog_stochastic`` the two gates are
    comparator-sampled under ``split(key, 4)[2:4]``; ``w_out`` takes no
    key, so it is digital, as in the reference."""
    acfg = cfg.analog
    pcfg = acfg.with_mode("analog_linear") if acfg.mode == "analog_stochastic" else acfg
    ks = (None,) * 4 if key is None else tuple(R.split(key, 4))
    main = A.analog_matmul(pcfg, ks[0], x, p["w_main"])
    gate_br = A.analog_matmul(pcfg, ks[1], x, p["w_gate_br"])
    main = PX.shard(_conv(main, p["conv_w"], p["conv_b"]), ("batch", "seq", "ffn"))
    mf = main.float()
    za, zx = _gate_logits(p, mf)
    if acfg.mode == "analog_stochastic" and ks[2] is not None:
        r = neurons.sigmoid_neuron_calibrated(ks[2], za, beta=acfg.beta)
        i = neurons.sigmoid_neuron_calibrated(ks[3], zx, beta=acfg.beta)
    else:
        r, i = torch.sigmoid(za), torch.sigmoid(zx)
    log_a = _C_EXP * r * _log_a_unit(p)
    h = rglru_scan(i * mf, log_a)
    y = h.to(x.dtype) * F.gelu(gate_br, approximate="tanh")
    return PX.shard(A.analog_matmul(pcfg, None, y, p["w_out"]), ("batch", "seq", "embed"))


def rglru_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Forward that also returns the decode state: (out (B, S, D), conv
    input tail (B, 3, W), last hidden h (B, W) f32).  It is
    :func:`rglru_prefill_chunk` from a zero carry, so the two cannot drift
    apart."""
    b = x.shape[0]
    w = p["w_main"].shape[-1]
    return rglru_prefill_chunk(
        p, x,
        torch.zeros((b, CONV_WIDTH - 1, w), dtype=x.dtype, device=x.device),
        torch.zeros((b, w), dtype=torch.float32, device=x.device),
        cfg,
    )


def rglru_prefill_chunk(p: dict, x: torch.Tensor, conv_cache: torch.Tensor,
                        h0: torch.Tensor, cfg: ModelConfig):
    """One chunk x (B, S, D) of a resumable prefill, the recurrence
    carried in from ``conv_cache`` (B, 3, W), the raw conv inputs before
    the chunk, and ``h0`` (B, W) f32.  Returns new tensors: (out (B, S,
    D), new conv tail (B, 3, W), last hidden h (B, W))."""
    main = x @ p["w_main"].to(x.dtype)
    gate_br = x @ p["w_gate_br"].to(x.dtype)
    new_tail = torch.cat([conv_cache.to(main.dtype), main], dim=1)[:, -(CONV_WIDTH - 1):, :]
    main_c = _conv(main, p["conv_w"], p["conv_b"], cache=conv_cache)
    mf = main_c.float()
    za, zx = _gate_logits(p, mf)
    r, i = torch.sigmoid(za), torch.sigmoid(zx)
    log_a = _C_EXP * r * _log_a_unit(p)
    h = rglru_scan(i * mf, log_a, h0=h0.float())
    y = h.to(x.dtype) * F.gelu(gate_br, approximate="tanh")
    out = y @ p["w_out"].to(y.dtype)
    return out, new_tail, h[:, -1, :].contiguous()


def rglru_decode_step(p: dict, x: torch.Tensor, conv_cache: torch.Tensor, h: torch.Tensor,
                      cfg: ModelConfig):
    """One token x (B, 1, D) from the carried ``conv_cache`` (B, 3, W) and
    ``h`` (B, W) f32; returns new tensors (out (B, 1, D), conv_cache',
    h').  The caller writes the state back in place."""
    x0 = x[:, 0, :]
    main = x0 @ p["w_main"].to(x.dtype)              # (B, W)
    gate_br = x0 @ p["w_gate_br"].to(x.dtype)
    window = torch.cat([conv_cache, main[:, None, :]], dim=1)
    wf = p["conv_w"].float()
    conv_out = torch.zeros_like(main, dtype=torch.float32)
    for k in range(window.shape[1]):
        conv_out = conv_out + window[:, k, :].float() * wf[k]
    conv_out = conv_out + p["conv_b"].float()
    # round through the activation dtype, as the prefill's conv output is
    conv_out = conv_out.to(x.dtype).float()
    za, zx = _gate_logits(p, conv_out)
    r, i = torch.sigmoid(za), torch.sigmoid(zx)
    a = torch.exp(_C_EXP * r * _log_a_unit(p))
    h = a * h + torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * (i * conv_out)
    y = h.to(x.dtype) * F.gelu(gate_br, approximate="tanh")
    out = (y @ p["w_out"].to(y.dtype))[:, None, :]
    return out, window[:, 1:, :], h
