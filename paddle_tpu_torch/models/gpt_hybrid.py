"""The single-device GPT pretraining step (counterpart of
``paddle_tpu/models/gpt_hybrid.py`` with ``mesh=None``):

    ids [B, S] -> embeddings -> L x remat(gpt_block_fn) -> final fp32 LN
      -> fused vocab-chunked head + CE -> backward -> global-norm clip
      -> AdamW

The reference's ``lax.scan`` over stacked ``[L, ...]`` block leaves is a
Python loop here. The leaves stay stacked, so parameter trees cross
between the frameworks unchanged, and each leaf is ``unbind``-ed once per
step outside the checkpointed blocks: the backward of ``unbind`` is one
stack into the ``[L, ...]`` gradient, where indexing ``blocks[k][l]``
inside the loop would allocate a full-size zero gradient per layer.

Every block runs under the remat policy (``distributed/recompute.py``),
also when ``config.remat`` is False, as the reference's ``gpt_hidden``
does: the switch is ``config.remat_policy``. Under ``"full"`` the backward
reruns each block's forward, the flash forward kernel included, so the
forward kernel launches twice per layer per step.

Meshes (tensor, pipeline, data parallelism), ZeRO stage 3 and host
offload are ROADMAP Queue A items 11 and 13 and raise
``NotImplementedError``. The reference's live step telemetry
(``StepSampler``) waits for item 10.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..device import resolve_device
from ..distributed.recompute import remat
from ..ops.fused_ce import fused_lm_loss
from .gpt import compute_dtype, gpt_block_fn
from .params import init_gpt_params, param_shapes


def _lm_loss(logits, ids):
    """Shifted next-token CE in fp32 from full logits [B, S, V] (the
    reference keeps it for vocab-sharded logits and as the fused loss's
    numeric reference)."""
    lg = logits[:, :-1].float()
    lb = ids[:, 1:].long()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, lb[..., None])[..., 0]
    return (logz - gold).mean()


def final_ln_fp32(x, g, b, eps):
    """Final LayerNorm in fp32, scaled and shifted in fp32; returns fp32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "meshes (dp/mp/pp/sp) are not ported yet (ROADMAP Queue A "
            "item 11); pass mesh=None")


def gpt_hidden(params, ids, config, mesh=None, num_microbatches=1):
    """Forward to final-LayerNorm hidden states [B, S, H] in the compute
    dtype. ``num_microbatches`` only matters to the pipeline, which needs
    a mesh."""
    _no_mesh(mesh)
    dt = compute_dtype(config)
    S = ids.shape[1]
    x = F.embedding(ids, params["wte"].to(dt)) + \
        params["wpe"].to(dt)[None, :S]
    block = remat(gpt_block_fn(config), config.remat_policy)
    blocks = params["blocks"]
    per_layer = {k: v.unbind(0) for k, v in blocks.items()}
    for layer in range(blocks["qkv_w"].shape[0]):
        x = block({k: v[layer] for k, v in per_layer.items()}, x)
    return final_ln_fp32(x, params["lnf_g"], params["lnf_b"],
                         config.layer_norm_epsilon).to(dt)


def gpt_forward(params, ids, config, mesh=None, num_microbatches=1):
    """Forward to logits [B, S, V] in the compute dtype."""
    hidden = gpt_hidden(params, ids, config, mesh, num_microbatches)
    return hidden @ params["head_w"].to(hidden.dtype)


def gpt_loss(params, ids, config):
    """The training loss of ``HybridTrainStep``: mean next-token CE of the
    fused head over ``gpt_hidden``."""
    hidden = gpt_hidden(params, ids, config)
    return fused_lm_loss(hidden, params["head_w"].to(hidden.dtype), ids)


def flatten_params(tree):
    """``{"wte": t, ..., "blocks/qkv_w": t, ...}`` of a parameter tree."""
    flat = {k: v for k, v in tree.items() if k != "blocks"}
    flat.update({f"blocks/{k}": v for k, v in tree["blocks"].items()})
    return flat


def unflatten_params(flat):
    tree = {k: v for k, v in flat.items() if not k.startswith("blocks/")}
    tree["blocks"] = {k[len("blocks/"):]: v for k, v in flat.items()
                      if k.startswith("blocks/")}
    return tree


def decays(name):
    """The reference's decay mask: no weight decay for biases (``*_b``),
    LayerNorm leaves (``ln`` in the name, so ``lnf_g``/``lnf_b`` too) and
    ``wpe``; ``wte`` and ``head_w`` decay."""
    leaf = name.rsplit("/", 1)[-1]
    return not (leaf.endswith("_b") or "ln" in leaf or leaf == "wpe")


class HybridTrainStep:
    """GPT train step on one device: ``step(ids)`` runs forward, backward,
    clip and the optimizer update, updating ``params`` and ``opt_state``
    in place, and returns the loss as a 0-dim tensor on the device (no
    host sync).

    ``params``: a tree from ``params_from_numpy`` (or the port's
    ``init_gpt_params``), copied to ``device`` in ``param_dtype``; without
    it, ``init_gpt_params(config, seed)`` draws the weights.
    ``num_microbatches`` only matters to the pipeline, which needs a
    mesh."""

    def __init__(self, config, optimizer, mesh=None, num_microbatches=1,
                 param_dtype=torch.float32, seed=0, zero_stage=1,
                 offload=False, device=None, params=None):
        _no_mesh(mesh)
        if zero_stage >= 3:
            raise NotImplementedError(
                "zero_stage >= 3 shards params over a mesh (ROADMAP Queue A "
                "items 11 and 13); the single-device step keeps stage 1")
        if offload:
            raise NotImplementedError(
                "host offload of optimizer moments is not ported yet "
                "(ROADMAP Queue A item 13)")
        self.config = config
        self.optimizer = optimizer
        self.device = resolve_device(device)
        copy = params is not None     # never update the caller's tree
        if params is None:
            params = init_gpt_params(config, seed=seed, device=self.device,
                                     dtype=param_dtype)
        shapes = flatten_params(param_shapes(config))
        flat = flatten_params(params)
        if set(flat) != set(shapes):
            raise KeyError(f"param tree keys {sorted(flat)} differ from the "
                           f"config's {sorted(shapes)}")
        self._flat = {}
        for name, t in flat.items():
            if tuple(t.shape) != tuple(shapes[name]):
                raise ValueError(f"param {name} has shape {tuple(t.shape)}, "
                                 f"the config needs {shapes[name]}")
            self._flat[name] = t.detach().to(
                self.device, param_dtype, copy=copy).requires_grad_(True)
        self.params = unflatten_params(self._flat)
        self.opt_state = optimizer.init_state(self._flat)
        self._wd_mask = {n: decays(n) for n in self._flat}

    def _ids(self, ids):
        return torch.as_tensor(ids).to(self.device, torch.long)

    def __call__(self, ids):
        ids = self._ids(ids)
        names = list(self._flat)
        # the record_function ranges name the step's parts in a
        # torch.profiler trace (chip_smoke.py's train profile reads them);
        # the backward gets none: autograd runs it on its own thread
        with torch.enable_grad():
            with record_function("train_step/forward"):
                loss = gpt_loss(self.params, ids, self.config)
            grads = torch.autograd.grad(loss, [self._flat[n] for n in names])
        clip = getattr(self.optimizer, "_grad_clip", None)
        if clip is not None:
            with record_function("train_step/clip"):
                grads = clip.apply_arrays(list(grads))
        with record_function("train_step/optimizer"):
            self.optimizer.apply_gradients(
                self._flat, dict(zip(names, grads)), self.opt_state,
                self.optimizer.get_lr(), wd_mask=self._wd_mask)
        return loss.detach()

    @torch.no_grad()
    def loss_only(self, ids):
        """Forward-only loss on the current params (no grads, no
        update)."""
        return gpt_loss(self.params, self._ids(ids), self.config)

    def num_params(self):
        return int(sum(t.numel() for t in self._flat.values()))
