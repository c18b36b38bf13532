"""GPT parameter trees (counterpart of ``init_gpt_params`` in
``paddle_tpu/models/gpt_hybrid.py``).

The tree has the reference's keys and shapes: ``wte`` [V, H], ``wpe``
[max_seq_len, H], ``lnf_g``/``lnf_b`` [H], ``head_w`` [H, V] and
``blocks`` with every per-layer leaf stacked on a leading [L] axis. So a
tree crosses between the frameworks as a dict of numpy arrays
(``params_from_numpy``), which is how the tests run both on the same
weights. Random values come from a ``torch.Generator`` and differ from
the reference's threefry values for the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .gpt import compute_dtype

BLOCK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
              "ln2_g", "ln2_b", "up_w", "up_b", "down_w", "down_b")
# leaves the reference reads in float32 whatever the compute dtype
# (generation._final_ln / _final_logits cast them to float32)
FP32_KEYS = ("lnf_g", "lnf_b", "head_w")


def param_shapes(config):
    """{key: shape} of the tree, with ``blocks`` nested."""
    H, L, V = config.hidden_size, config.num_layers, config.vocab_size
    inner = config.ffn_mult * H
    blocks = {
        "ln1_g": (L, H), "ln1_b": (L, H),
        "qkv_w": (L, H, 3 * H), "qkv_b": (L, 3 * H),
        "out_w": (L, H, H), "out_b": (L, H),
        "ln2_g": (L, H), "ln2_b": (L, H),
        "up_w": (L, H, inner), "up_b": (L, inner),
        "down_w": (L, inner, H), "down_b": (L, H),
    }
    return {"wte": (V, H), "wpe": (config.max_seq_len, H), "lnf_g": (H,),
            "lnf_b": (H,), "head_w": (H, V), "blocks": blocks}


def init_gpt_params(config, seed=0, device=None, dtype=torch.float32):
    """Random GPT params: normal(0, initializer_range) projections and
    embeddings, ones/zeros LayerNorms, zero biases — the reference's
    recipe, drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``. Values are drawn in float32 and stored in ``dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    std = config.initializer_range
    shapes = param_shapes(config)
    bs = shapes["blocks"]

    def norm(shape):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def const(shape, fill):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    # draw order follows the reference's key split: qkv, out, up, down,
    # wte, wpe, head
    drawn = {k: norm(bs[k]) for k in ("qkv_w", "out_w", "up_w", "down_w")}
    blocks = {}
    for k in BLOCK_KEYS:
        if k in drawn:
            blocks[k] = drawn[k]
        else:
            blocks[k] = const(bs[k], 1.0 if k.endswith("_g") else 0.0)
    out = {"wte": norm(shapes["wte"]), "wpe": norm(shapes["wpe"])}
    head = norm(shapes["head_w"])
    out.update(lnf_g=const(shapes["lnf_g"], 1.0),
               lnf_b=const(shapes["lnf_b"], 0.0), head_w=head,
               blocks=blocks)
    return out


def params_from_numpy(tree, config, device=None, dtype=torch.float32):
    """The reference's parameter tree, handed over as numpy arrays (or
    anything ``np.asarray`` takes), as the port's torch tree on
    ``device`` in ``dtype``. Keys and shapes are checked against
    ``config``."""
    dev = resolve_device(device)
    shapes = param_shapes(config)

    def conv(name, arr, shape):
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"param {name} has shape {a.shape}, the config "
                             f"needs {shape}")
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    missing = set(shapes) - set(tree) | \
        set(shapes["blocks"]) - set(tree.get("blocks", {}))
    if missing:
        raise KeyError(f"param tree lacks {sorted(missing)}")
    out = {k: conv(k, tree[k], s) for k, s in shapes.items()
           if k != "blocks"}
    out["blocks"] = {k: conv("blocks." + k, tree["blocks"][k], s)
                     for k, s in shapes["blocks"].items()}
    return out


# storage dtypes of quantized GEMM weights (serving/quant.py), kept as
# they are: the quantized GEMM reads them with their ``<name>_s`` scales
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def cast_for_compute(params, config, device=None):
    """The reference's per-use casts done once, at load: every leaf its
    forward casts to the compute dtype (``p[name].astype(h.dtype)``, the
    embeddings) is stored in that dtype, and the final LayerNorm and LM
    head stay float32 as ``_final_logits`` reads them. Values are those
    the reference computes with; at bf16 the weight bytes halve. A
    quantized tree (``serving.quant.quantize_params``) keeps its int8/fp8
    weights and their float32 ``<name>_s`` scales. ``device=None`` keeps
    the tree where it is."""
    dt = compute_dtype(config)
    dev = None if device is None else torch.device(device)

    def put(tree, name, dtype):
        t = tree[name]
        if t.dtype in QUANT_DTYPES:
            dtype = t.dtype
        elif name.endswith("_s") and \
                getattr(tree.get(name[:-2]), "dtype", None) in QUANT_DTYPES:
            dtype = torch.float32       # the scale of a quantized weight
        return t.to(dev if dev is not None else t.device, dtype)

    out = {k: put(params, k, torch.float32 if k in FP32_KEYS else dt)
           for k in params if k != "blocks"}
    blocks = params["blocks"]
    out["blocks"] = {k: put(blocks, k, dt) for k in blocks}
    return out


def layer_params(params):
    """Per-layer views ``[{key: blocks[key][l]}]`` of the stacked blocks —
    built once per forward caller instead of once per layer per step."""
    blocks = params["blocks"]
    L = blocks["qkv_w"].shape[0]
    return [{k: v[i] for k, v in blocks.items()} for i in range(L)]


def gpt_param_specs():
    """The sharded dim of every leaf under tensor parallelism (None:
    replicated), the reference's ``gpt_param_specs(zero_stage=1, pp=1)``
    (``gpt_hybrid.py:81-111``): ``wte`` vocab rows and ``head_w`` vocab
    columns over mp; per block the qkv and up projections (and their
    biases) by columns, out and down by rows, on the stacked [L, ...]
    leaves one dim later; LayerNorms, the row-parallel biases, ``wpe``
    and ``lnf_*`` replicated."""
    from ..distributed.tp_overlap import SP_BLOCK_PARAM_SPECS
    return {"wte": 0, "wpe": None, "lnf_g": None, "lnf_b": None,
            "head_w": 1,
            "blocks": {k: None if d is None else d + 1
                       for k, d in SP_BLOCK_PARAM_SPECS.items()}}


def _leaves(tree):
    yield from ((k, v) for k, v in tree.items() if k != "blocks")
    yield from ((("blocks", k), v) for k, v in tree["blocks"].items())


def _put(tree, key, value):
    if isinstance(key, tuple):
        tree.setdefault("blocks", {})[key[1]] = value
    else:
        tree[key] = value


def _spec(specs, key):
    return specs["blocks"][key[1]] if isinstance(key, tuple) else specs[key]


def shard_params(params, rank, n):
    """Rank ``rank``'s shards of a full tree for an ``n``-rank group
    (``gpt_param_specs``): each sharded leaf's 1/n block along its dim,
    replicated leaves as they are (views of ``params``, not copies; a
    block is made contiguous where it is not). The qkv leaves must
    be head-major already (``tp_overlap.to_qkv_head_major``), so that a
    block of columns is whole heads."""
    specs = gpt_param_specs()
    out = {}
    for key, t in _leaves(params):
        d = _spec(specs, key)
        if d is not None:
            if t.shape[d] % n:
                raise ValueError(f"param {key} dim {d} ({t.shape[d]}) is "
                                 f"not divisible by {n}")
            w = t.shape[d] // n
            t = t.narrow(d, rank * w, w).contiguous()
        _put(out, key, t)
    return out


def gather_params(shards, n):
    """The full tree from the ``n`` ranks' shards (a list in rank order):
    sharded leaves concatenated along their dim, replicated leaves from
    rank 0. Inverse of ``shard_params``."""
    if len(shards) != n:
        raise ValueError(f"need {n} shards, got {len(shards)}")
    specs = gpt_param_specs()
    out = {}
    for key, t in _leaves(shards[0]):
        d = _spec(specs, key)
        if d is not None:
            parts = [s[key[0]][key[1]] if isinstance(key, tuple) else s[key]
                     for s in shards]
            t = torch.cat(parts, dim=d)
        _put(out, key, t)
    return out


# leaves outside the blocks, by the pipeline stage that owns them
FIRST_STAGE_KEYS = ("wte", "wpe")
LAST_STAGE_KEYS = ("lnf_g", "lnf_b", "head_w")


def stage_params(params, stage, n):
    """Stage ``stage``'s part of a full tree for an ``n``-stage pipeline:
    the blocks' layers [stage L/n, (stage + 1) L/n) (views of ``params``),
    ``wte`` and ``wpe`` on stage 0, ``lnf_*`` and ``head_w`` on stage
    n - 1. The reference keeps those non-block leaves replicated on every
    stage (its GSPMD partitioner places their use); here only the stage
    that runs the embedding or the loss holds them, so no stage stores,
    updates or synchronises a leaf it never reads."""
    L = params["blocks"]["qkv_w"].shape[0]
    if L % n:
        raise ValueError(f"{L} layers do not split into {n} stages")
    per = L // n
    out = {k: params[k] for k in FIRST_STAGE_KEYS if stage == 0}
    out.update({k: params[k] for k in LAST_STAGE_KEYS if stage == n - 1})
    out["blocks"] = {k: v[stage * per:(stage + 1) * per]
                     for k, v in params["blocks"].items()}
    return out


def gather_stage_params(shards, n):
    """The full tree from the ``n`` stages' parts (a list in stage order):
    blocks concatenated on the layer axis, the other leaves from the stage
    that owns them. Inverse of ``stage_params``."""
    if len(shards) != n:
        raise ValueError(f"need {n} stages, got {len(shards)}")
    out = {k: shards[0][k] for k in FIRST_STAGE_KEYS}
    out.update({k: shards[-1][k] for k in LAST_STAGE_KEYS})
    out["blocks"] = {k: torch.cat([s["blocks"][k] for s in shards])
                     for k in shards[0]["blocks"]}
    return out


# the eager GPTForCausalLM's parameter names (the reference Layer's) and
# the functional tree's keys: per block, "gpt.h.<l>.<name>" is
# blocks[key][l]
OUTER_LAYER_NAMES = {"lm_head.weight": "head_w", "gpt.wte.weight": "wte",
                     "gpt.wpe.weight": "wpe", "gpt.ln_f.weight": "lnf_g",
                     "gpt.ln_f.bias": "lnf_b"}
BLOCK_LAYER_NAMES = {
    "ln_1.weight": "ln1_g", "ln_1.bias": "ln1_b",
    "attn.qkv_proj.weight": "qkv_w", "attn.qkv_proj.bias": "qkv_b",
    "attn.out_proj.weight": "out_w", "attn.out_proj.bias": "out_b",
    "ln_2.weight": "ln2_g", "ln_2.bias": "ln2_b",
    "mlp.up_proj.weight": "up_w", "mlp.up_proj.bias": "up_b",
    "mlp.down_proj.weight": "down_w", "mlp.down_proj.bias": "down_b"}


def layer_params_from_tree(tree):
    """{Layer name: tensor} of a functional tree (views of its leaves):
    the weights and ids of the functional phases carried to the eager
    model (the inverse of ``tree_from_layer_params``)."""
    out = {name: tree[key] for name, key in OUTER_LAYER_NAMES.items()}
    L = tree["blocks"]["qkv_w"].shape[0]
    for layer in range(L):
        for name, key in BLOCK_LAYER_NAMES.items():
            out[f"gpt.h.{layer}.{name}"] = tree["blocks"][key][layer]
    return out


def tree_from_layer_params(named, config):
    """The functional tree of a ``{Layer name: tensor}`` dict (blocks
    stacked on a leading [L] axis)."""
    out = {key: named[name] for name, key in OUTER_LAYER_NAMES.items()}
    out["blocks"] = {key: torch.stack([named[f"gpt.h.{layer}.{name}"]
                                       for layer in range(config.num_layers)])
                     for name, key in BLOCK_LAYER_NAMES.items()}
    return out


@torch.no_grad()
def layer_params_from_numpy(model, arrays):
    """Copy ``{name: array}`` (the reference Layer's ``named_parameters``,
    handed over as numpy arrays or tensors) into ``model``'s parameters of
    those names, in place, cast to each parameter's dtype. The names and
    shapes must be the model's, all of them."""
    params = dict(model.named_parameters())
    if set(arrays) != set(params):
        raise KeyError(f"names differ: missing "
                       f"{sorted(set(params) - set(arrays))}, unknown "
                       f"{sorted(set(arrays) - set(params))}")
    for name, p in params.items():
        a = arrays[name]
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a, np.float32))
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"param {name} has shape {tuple(t.shape)}, the "
                             f"model needs {tuple(p.shape)}")
        p.copy_(t)
    return model
