"""Serving-side quantization (counterpart of ``paddle_tpu/serving/quant.py``):
int8/fp8 weight-only GEMMs and the quantized paged KV pool, calibrated
through ``paddle_tpu_torch.quantization``.

Two independent dtype axes, both off by default
(``FLAGS_serving_weight_dtype`` / ``FLAGS_serving_kv_dtype`` = "bf16":
full precision, and none of this module's code runs):

* **weights**: per-output-channel symmetric scales, the absmax of each
  output column at engine build or pinned by a calibration
  (``calibrate``). Each stored GEMM weight becomes int8/fp8 with a float32
  ``<name>_s`` companion; the dequant multiply is the epilogue of the GEMM
  (``ops.quant_gemm``), so no full-precision weight copy exists.
* **KV**: per-page scales beside the page table
  (``PagedKVPool.k_scale``/``v_scale`` [L, P]). Writes quantize in
  ``paged_kv_scatter``; reads dequantize inside the paged-decode kernel
  and in the gather path. The scale values come from per-layer |K|/|V|
  clip ranges: a calibration over a token sample (``kv_ranges``), or the
  automatic one-forward calibration at engine build
  (``ensure_kv_clips``).

A quantized engine is exact at its dtype config (deterministic and
admission-order invariant); the bf16/bf16 config resolves to None and the
engine is byte for byte the unquantized one.

The speculative draft is derived from the served tree, never loaded
(``DraftSpec``, ``resolve_draft``, ``shallow_draft_params``). Snapshots
of a quantized pool (``QuantDtypeMismatchError``) come with a later
slice.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

DTYPES = ("bf16", "int8", "fp8")
# storage dtype and symmetric max of each quantized dtype ("bf16" means
# full precision: the serving path never casts to it)
STORE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
QMAX = {"int8": 127.0, "fp8": 448.0}
# stacked block GEMM weights that quantize (scale [L, out]); head_w
# quantizes too (scale [V]). Embeddings, norms and biases stay fp.
BLOCK_WEIGHTS = ("qkv_w", "out_w", "up_w", "down_w")


class QuantSpecError(ValueError):
    """A QuantSpec that cannot serve these params/config: unknown dtype,
    or calibrated scale/clip shapes that do not match the tree (the error
    names the leaf)."""


@dataclass
class QuantSpec:
    """Serving-quantization config plus optional calibrated artifacts.

    ``weight_scales`` pins per-output-channel fp32 scales:
    ``{"blocks": {leaf: [L, out]}, "head_w": [V]}``. ``kv_k_clip`` /
    ``kv_v_clip`` are per-layer |K| / |V| clip ranges ([L]); the pool
    divides them by its dtype's qmax for the per-page scales. None means
    automatic: absmax weights at build, KV clips from one fp forward."""

    weight_dtype: str = "bf16"
    kv_dtype: str = "bf16"
    weight_scales: dict | None = None
    kv_k_clip: np.ndarray | None = None
    kv_v_clip: np.ndarray | None = None

    def __post_init__(self):
        for name, d in (("weight_dtype", self.weight_dtype),
                        ("kv_dtype", self.kv_dtype)):
            if d not in DTYPES:
                raise QuantSpecError(
                    f"{name} must be one of {DTYPES}, got {d!r}")

    @property
    def active(self):
        return self.weight_dtype != "bf16" or self.kv_dtype != "bf16"

    @property
    def quantizes_weights(self):
        return self.weight_dtype != "bf16"

    @property
    def quantizes_kv(self):
        return self.kv_dtype != "bf16"


def resolve(quant, flags):
    """The Engine's ``quant=``: a QuantSpec passes through, a dtype string
    ("int8"/"fp8") quantizes both axes, None reads
    ``FLAGS_serving_weight_dtype``/``FLAGS_serving_kv_dtype``. Returns None
    for the full-precision bf16/bf16 config."""
    if isinstance(quant, QuantSpec):
        return quant if quant.active else None
    if isinstance(quant, str):
        spec = QuantSpec(weight_dtype=quant, kv_dtype=quant)
        return spec if spec.active else None
    if quant is not None:
        raise QuantSpecError(
            f"quant= must be a QuantSpec, a dtype string or None, got "
            f"{type(quant).__name__}")
    spec = QuantSpec(
        weight_dtype=str(flags.get("FLAGS_serving_weight_dtype", "bf16")),
        kv_dtype=str(flags.get("FLAGS_serving_kv_dtype", "bf16")))
    return spec if spec.active else None


def page_scales(clip, num_pages, qmax):
    """The per-page scale seeding rule: every page of layer l starts at
    ``clip[l] / qmax`` (clip floored at 1e-8); the trash page (physical 0)
    keeps 1.0, which keeps its garbage writes finite. [L, P] float32."""
    clip = np.asarray(clip, np.float64)
    out = np.ones((clip.shape[0], int(num_pages)), np.float32)
    out[:, 1:] = (np.maximum(clip, 1e-8) / float(qmax))[:, None]
    return out


# -- validation (up front, naming the leaf) ---------------------------------
def _expected_scale_shapes(params):
    blocks = params["blocks"]
    out = {f"blocks.{name}": (int(blocks[name].shape[0]),
                              int(blocks[name].shape[-1]))
           for name in BLOCK_WEIGHTS}
    out["head_w"] = (int(params["head_w"].shape[-1]),)
    return out


def validate(spec, params, config):
    """Refuse a spec whose calibrated artifacts do not match this tree
    before anything is built; the error names the leaf."""
    if spec.weight_scales is not None:
        expected = _expected_scale_shapes(params)
        given = dict(spec.weight_scales)
        flat = {f"blocks.{k}": v for k, v in given.pop("blocks", {}).items()}
        flat.update(given)
        for leaf, arr in flat.items():
            if leaf not in expected:
                raise QuantSpecError(
                    f"QuantSpec.weight_scales names leaf {leaf!r}, which "
                    f"is not a quantized serving weight "
                    f"({sorted(expected)})")
            shape = tuple(np.shape(arr))
            if shape != expected[leaf]:
                raise QuantSpecError(
                    f"QuantSpec.weight_scales[{leaf!r}] has shape {shape} "
                    f"but the params tree needs {expected[leaf]} "
                    f"(per-output-channel scales)")
        missing = [k for k in expected if k not in flat]
        if missing:
            raise QuantSpecError(
                f"QuantSpec.weight_scales is missing scales for "
                f"{missing}; calibrate() produces the full set")
    if spec.quantizes_kv:
        L = int(config.num_layers)
        for name, clip in (("kv_k_clip", spec.kv_k_clip),
                           ("kv_v_clip", spec.kv_v_clip)):
            if clip is not None and np.shape(clip) != (L,):
                raise QuantSpecError(
                    f"QuantSpec.{name} has shape {np.shape(clip)} but the "
                    f"model has {L} layers (one clip per layer)")
    return spec


# -- weight quantization ----------------------------------------------------
def _quantize_leaf(w, dtype, scale=None):
    """Per-output-channel symmetric quantization of a GEMM weight
    [..., K, F] along its last axis, in the reference's fp32 op order
    (``w / s``, int8: round half to even then clip; fp8: clip to ±448
    then cast, since a torch fp8 cast does not saturate). Returns
    (q, scale fp32 [..., F]) on w's device."""
    wf = torch.as_tensor(w).float()
    qmax = QMAX[dtype]
    if scale is None:
        scale = wf.abs().amax(dim=-2).clamp(min=1e-8) / qmax
    else:
        scale = torch.as_tensor(np.asarray(scale, np.float32)).to(wf.device)
    scaled = wf / scale.unsqueeze(-2)
    if dtype == "int8":
        q = torch.clamp(torch.round(scaled), -128, 127).to(torch.int8)
    else:
        q = torch.clamp(scaled, -qmax, qmax).to(STORE_DTYPES[dtype])
    return q, scale.float()


def quantize_params(params, config, spec, qkv_perm=None):
    """The serving GEMM weights of an ``init_gpt_params`` tree quantized to
    ``spec.weight_dtype``, each with a fp32 ``<name>_s`` scale leaf. Pinned
    ``spec.weight_scales`` are honored, otherwise fresh absmax scales.
    ``qkv_perm`` (the tensor-parallel engine, whose tree the caller has
    permuted head-major) relabels the pinned qkv scales, which are
    recorded on the logical layout, with the columns. Other leaves are
    passed through as they are."""
    del config
    if not spec.quantizes_weights:
        return params
    pinned = spec.weight_scales or {}
    pinned_blocks = dict(pinned.get("blocks", {}))
    if qkv_perm is not None and "qkv_w" in pinned_blocks:
        pinned_blocks["qkv_w"] = np.asarray(
            pinned_blocks["qkv_w"])[..., qkv_perm]
    blocks = dict(params["blocks"])
    for name in BLOCK_WEIGHTS:
        blocks[name], blocks[name + "_s"] = _quantize_leaf(
            blocks[name], spec.weight_dtype, pinned_blocks.get(name))
    out = dict(params)
    out["blocks"] = blocks
    out["head_w"], out["head_w_s"] = _quantize_leaf(
        params["head_w"], spec.weight_dtype, pinned.get("head_w"))
    return out


def scale_bytes(params):
    """Bytes of the fp32 scale leaves a quantized tree carries."""
    leaves = dict(params.get("blocks", {}))
    leaves["head_w_s"] = params.get("head_w_s")
    return sum(int(np.prod(tuple(a.shape))) * 4 for name, a in leaves.items()
               if name.endswith("_s") and a is not None)


# -- calibration (quantization observers -> QuantSpec) ----------------------
def _observer_clip(obs):
    """Symmetric clip range of an observer: scales() is clip / qmax."""
    return np.asarray(obs.scales(), np.float64) * \
        (2.0 ** (obs.bit_length() - 1) - 1.0)


def _calibration_sample(config, n_tokens):
    """The deterministic token sweep of the automatic KV calibration."""
    T = max(2, min(int(n_tokens), config.max_seq_len))
    return (np.arange(T, dtype=np.int32) * 7 + 1) % config.vocab_size


@torch.no_grad()
def kv_ranges(params, config, sample_ids=None, n_tokens=64,
              observer_factory=None):
    """Per-layer |K| / |V| clip ranges from one full-precision prefill over
    ``sample_ids`` (default: the deterministic sweep), recorded through
    observers (``AbsmaxObserver`` by default; e.g.
    ``lambda: PercentileObserver(99.9)`` clips outliers). Runs where the
    params live. Returns (k_clip [L], v_clip [L]) float64."""
    from ..models.generation import _forward_cached
    from ..models.gpt import compute_dtype
    from ..models.params import cast_for_compute
    from ..quantization import AbsmaxObserver
    if sample_ids is None:
        sample_ids = _calibration_sample(config, n_tokens)
    ids = np.asarray(sample_ids, np.int64)[None]
    T = ids.shape[1]
    if T > config.max_seq_len:
        raise QuantSpecError(
            f"calibration sample ({T} tokens) exceeds the model's "
            f"max_seq_len ({config.max_seq_len})")
    p = cast_for_compute(params, config)
    dev = p["wte"].device
    L, nh = config.num_layers, config.num_heads
    d = config.hidden_size // nh
    kc = torch.zeros((L, 1, T, nh, d), dtype=compute_dtype(config),
                     device=dev)
    vc = torch.zeros_like(kc)
    _forward_cached(p, config, torch.from_numpy(ids).to(dev), kc, vc, 0)
    make = observer_factory or AbsmaxObserver
    k_clip, v_clip = np.zeros(L), np.zeros(L)
    for layer in range(L):
        ok, ov = make(), make()
        ok.observe(kc[layer])
        ov.observe(vc[layer])
        ok.cal_thresholds()
        ov.cal_thresholds()
        k_clip[layer] = float(np.max(_observer_clip(ok)))
        v_clip[layer] = float(np.max(_observer_clip(ov)))
    return k_clip, v_clip


def calibrate(params, config, sample_ids=None, weight_dtype="int8",
              kv_dtype="int8", kv_observer=None):
    """Calibration: run the observers over the params tree and a token
    sample, producing a ``QuantSpec`` (per-output-channel weight scales +
    per-layer KV clip ranges) that ``Engine(quant=...)`` accepts."""
    from ..quantization import PerChannelAbsmaxObserver
    spec = QuantSpec(weight_dtype=weight_dtype, kv_dtype=kv_dtype)
    if spec.quantizes_weights:
        qmax = QMAX[weight_dtype]

        def channel_scales(w):
            obs = PerChannelAbsmaxObserver(quant_axis=w.ndim - 1)
            obs.observe(w)
            obs.cal_thresholds()
            return np.maximum(_observer_clip(obs), 1e-8) / qmax

        blocks = {}
        for name in BLOCK_WEIGHTS:
            w = params["blocks"][name]
            # one observer per layer over its [K, F] slice
            blocks[name] = np.stack([channel_scales(w[layer])
                                     for layer in range(w.shape[0])]
                                    ).astype(np.float32)
        head_s = channel_scales(params["head_w"]).astype(np.float32)
        spec = replace(spec, weight_scales={"blocks": blocks,
                                            "head_w": head_s})
    if spec.quantizes_kv:
        k_clip, v_clip = kv_ranges(params, config, sample_ids,
                                   observer_factory=kv_observer)
        spec = replace(spec, kv_k_clip=k_clip, kv_v_clip=v_clip)
    return validate(spec, params, config)


def ensure_kv_clips(spec, params, config):
    """Fill missing KV clip ranges by the automatic calibration (one fp
    forward over the deterministic sample). Returns the spec."""
    if not spec.quantizes_kv or (spec.kv_k_clip is not None
                                 and spec.kv_v_clip is not None):
        return spec
    k_clip, v_clip = kv_ranges(params, config)
    return replace(spec,
                   kv_k_clip=spec.kv_k_clip if spec.kv_k_clip is not None
                   else k_clip,
                   kv_v_clip=spec.kv_v_clip if spec.kv_v_clip is not None
                   else v_clip)


def kv_scales_for(spec, num_layers, num_pages):
    """(k_scale, v_scale) [L, P] float32 numpy of a pool at ``spec``'s kv
    dtype, seeded by ``page_scales`` from its clip ranges."""
    qmax = QMAX[spec.kv_dtype]
    return tuple(page_scales(np.broadcast_to(np.asarray(c, np.float64),
                                             (int(num_layers),)),
                             num_pages, qmax)
                 for c in (spec.kv_k_clip, spec.kv_v_clip))


# -- drift measurement -------------------------------------------------------
@torch.no_grad()
def max_logit_drift(params, config, spec, prompt, page_size=8):
    """Max |logits_fp - logits_quant| of one prefill forward over
    ``prompt`` through the paged serving forward, on the params' device.
    The quantized GEMMs take the route the engine takes: the CUDA kernel
    on CUDA tensors unless ``FLAGS_serving_quant_kernel`` is off.
    Returns (max_abs_drift, max_abs_fp_logit)."""
    from ..flags import get_flags
    from ..models.gpt import compute_dtype
    from ..models.params import cast_for_compute
    from .paged_attention import new_pool, paged_forward
    from .paged_kv import pages_for
    spec = ensure_kv_clips(spec, params, config)
    prompt = np.asarray(prompt, np.int64)
    T = len(prompt)
    L, nh = config.num_layers, config.num_heads
    d = config.hidden_size // nh
    MP = pages_for(T, page_size)
    P = MP + 1
    fp = cast_for_compute(params, config)
    dev = fp["wte"].device
    i32 = dict(dtype=torch.int32, device=dev)
    ids = torch.from_numpy(prompt)[None].to(dev)
    start = torch.zeros(1, **i32)
    valid = torch.tensor([T], **i32)
    table = torch.arange(1, MP + 1, **i32)[None]
    wq_kernel = bool(get_flags("FLAGS_serving_quant_kernel")
                     ["FLAGS_serving_quant_kernel"])

    def run(p, dtype, kv_scales):
        shape = (L, P, page_size, nh, d)
        kc, vc = new_pool(shape, dtype, dev), new_pool(shape, dtype, dev)
        return paged_forward(p, config, ids, kc, vc, start, valid, table,
                             page_size, kv_scales=kv_scales,
                             wq_kernel=wq_kernel).double()

    ref = run(fp, compute_dtype(config), None)
    qparams = cast_for_compute(quantize_params(params, config, spec), config)
    kv_scales = None
    kv_dtype = compute_dtype(config)
    if spec.quantizes_kv:
        kv_dtype = STORE_DTYPES[spec.kv_dtype]
        kv_scales = tuple(torch.from_numpy(s).to(dev)
                          for s in kv_scales_for(spec, L, P))
    got = run(qparams, kv_dtype, kv_scales)
    return (float((ref - got).abs().max()), float(ref.abs().max()))


# -- speculative-draft plumbing (the draft model is derived, never loaded) --
DRAFT_SOURCES = ("quant", "shallow")


@dataclass
class DraftSpec:
    """Speculative-decoding config: how many tokens the draft proposes per
    boundary (``k``) and where the draft model comes from: ``"quant"``
    (int8 self-draft: the engine's own weights quantized per channel; the
    engine's weights themselves when it already serves quantized ones) or
    ``"shallow"`` (the first ``layers`` transformer blocks of the same
    tree, sharing embeddings, final LayerNorm and head). ``layers=0``
    means auto (num_layers // 2, at least 1)."""

    k: int
    source: str = "quant"
    layers: int = 0

    def __post_init__(self):
        self.k = int(self.k)
        if self.k < 1:
            raise QuantSpecError(f"DraftSpec.k must be >= 1, got {self.k}")
        if self.source not in DRAFT_SOURCES:
            raise QuantSpecError(
                f"DraftSpec.source must be one of {DRAFT_SOURCES}, got "
                f"{self.source!r}")
        self.layers = int(self.layers)
        if self.layers < 0:
            raise QuantSpecError(
                f"DraftSpec.layers must be >= 0 (0 = auto), got "
                f"{self.layers}")

    def num_layers(self, total_layers):
        if self.source != "shallow":
            return int(total_layers)
        n = self.layers or max(1, int(total_layers) // 2)
        return min(n, int(total_layers))


def resolve_draft(speculate_k, source, layers, flags):
    """The Engine's speculation arguments: explicit ones win, None falls
    back to ``FLAGS_serving_speculate_k`` / ``_draft_source`` /
    ``_draft_layers``. Returns None when the resolved k is 0 (the engine
    then runs none of the speculative code)."""
    k = (int(flags.get("FLAGS_serving_speculate_k", 0))
         if speculate_k is None else int(speculate_k))
    if k <= 0:
        return None
    src = (str(flags.get("FLAGS_serving_draft_source", "quant"))
           if source is None else str(source))
    n = (int(flags.get("FLAGS_serving_draft_layers", 0))
         if layers is None else int(layers))
    return DraftSpec(k=k, source=src, layers=n)


def shallow_draft_params(params, n_layers):
    """A (possibly quantized) tree cut to its first ``n_layers`` blocks.
    Embeddings, final LayerNorm and head are the full tree's tensors (no
    copy); the stacked block leaves and their ``_s`` scales are sliced
    (views)."""
    out = dict(params)
    out["blocks"] = {name: leaf[:n_layers]
                     for name, leaf in params["blocks"].items()}
    return out
