"""The decoder stack shared by the ``decoder_lm`` and ``moe_lm`` families:
the port's ``ModelConfig`` of a configuration file, and the weights, made
on the device from ``--seed`` in the port's parameter layout, each stacked
leaf in one draw.

Matrices are N(0, 1/fan) drawn in f32 and cast to the model's dtype (the
port's and the JAX package's init rule); the MoE router stays f32; the
norm scales (applied as ``1 + scale``) are 0.1·N(0, 1) in f32 rather than
the init's zeros, so the check sees a norm whose scale is not read.  The
same tensors go to the program and to the plain reference
(``reference/model.py``), which implements what this module accepts and
nothing more: a gated MLP of ``hidden_act`` ``silu`` (SwiGLU) and one
global-attention layer kind.
"""

from __future__ import annotations

import dataclasses

import torch

from ..reference import model as reference  # noqa: F401  (the family's plain reference)

# hidden_act of the configuration file -> the port's MLP kind
MLP_OF_ACT = {"silu": "swiglu"}


def model_config(conf: dict, traffic: dict):
    """The port's ``ModelConfig`` of a configuration file and the traffic's
    sampler.  Refuses what the reference does not implement."""
    from repro_torch.core.analog import DIGITAL
    from repro_torch.models.config import ModelConfig

    act = conf["hidden_act"]
    if act not in MLP_OF_ACT:
        raise NotImplementedError(f"hidden_act {act!r}: the plain reference has only {sorted(MLP_OF_ACT)}")
    pattern = tuple(conf.get("layer_pattern", ("global",)))
    if pattern != ("global",):
        raise NotImplementedError(f"layer_pattern {pattern}: the plain reference has only global attention")
    sampler = traffic["sampler"]
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    kw = dict(
        name=conf["name"], family=conf["family"], n_layers=conf["num_hidden_layers"],
        d_model=d, n_heads=h, n_kv_heads=conf["num_key_value_heads"],
        d_head=conf.get("head_dim") or d // h, d_ff=conf["intermediate_size"],
        vocab=conf["vocab_size"], mlp=MLP_OF_ACT[act], layer_pattern=pattern,
        norm_eps=conf.get("rms_norm_eps", conf.get("norm_eps")), rope_theta=conf["rope_theta"],
        tie_embeddings=conf["tie_word_embeddings"], dtype=conf["torch_dtype"],
        max_seq=conf["max_position_embeddings"], wta_head=sampler["kind"] == "wta",
        analog=dataclasses.replace(DIGITAL, wta_trials=sampler.get("trials", DIGITAL.wta_trials),
                                   beta=sampler.get("beta", DIGITAL.beta)),
    )
    if conf.get("num_local_experts"):
        kw.update(n_experts=conf["num_local_experts"], moe_topk=conf["num_experts_per_tok"],
                  capacity_factor=conf["capacity_factor"])
    return ModelConfig(**kw)


def _normal(gen: torch.Generator, shape: tuple, std: float, dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


def make_weights(mcfg, seed: int, device) -> dict:
    """{"embed", "final_norm", ["head"], "units": {"l0": ...}}, stacked over
    ``n_layers`` on the leading axis."""
    if tuple(mcfg.layer_pattern) != ("global",) or mcfg.mlp != "swiglu":
        raise NotImplementedError(f"weights for {mcfg.layer_pattern} / {mcfg.mlp}")
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, mcfg.dtype)
    f32 = torch.float32
    nu, d, f, v = mcfg.n_layers, mcfg.d_model, mcfg.d_ff, mcfg.vocab
    hq, hkv = mcfg.n_heads * mcfg.head_dim, mcfg.n_kv_heads * mcfg.head_dim
    params = {
        "embed": {"embedding": _normal(gen, (v, d), d**-0.5, dt)},
        "final_norm": {"scale": _normal(gen, (d,), 0.1, f32)},
    }
    if not mcfg.tie_embeddings:
        params["head"] = {"w": _normal(gen, (d, v), d**-0.5, dt)}
    unit = {
        "ln1": {"scale": _normal(gen, (nu, d), 0.1, f32)},
        "attn": {
            "wq": _normal(gen, (nu, d, hq), d**-0.5, dt),
            "wk": _normal(gen, (nu, d, hkv), d**-0.5, dt),
            "wv": _normal(gen, (nu, d, hkv), d**-0.5, dt),
            "wo": _normal(gen, (nu, hq, d), hq**-0.5, dt),
        },
        "ln2": {"scale": _normal(gen, (nu, d), 0.1, f32)},
    }
    if mcfg.n_experts:
        e = mcfg.n_experts
        unit["moe"] = {
            "router": _normal(gen, (nu, d, e), d**-0.5, dt).to(f32),
            "w_up": _normal(gen, (nu, e, d, f), d**-0.5, dt),
            "w_down": _normal(gen, (nu, e, f, d), f**-0.5, dt),
            "w_gate": _normal(gen, (nu, e, d, f), d**-0.5, dt),
        }
    else:
        unit["ffn"] = {
            "w_up": _normal(gen, (nu, d, f), d**-0.5, dt),
            "w_down": _normal(gen, (nu, f, d), f**-0.5, dt),
            "w_gate": _normal(gen, (nu, d, f), d**-0.5, dt),
        }
    params["units"] = {"l0": unit}
    return params
