"""Per-rank functions of tests/test_torch_pp_train.py (and of the pipeline
card test in tests/test_torch_cuda_kernels.py), run by
``paddle_tpu_torch.distributed.env.launch`` in spawned ranks, one per
pipeline stage. A spawned child imports the module that holds its
function, so this module imports neither jax nor the reference package:
the JAX side runs in the test process and arrives here as numpy."""
import dataclasses

import torch

from paddle_tpu_torch.distributed import pipeline as pl
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.models import GPTConfig, HybridTrainStep
from paddle_tpu_torch.models.gpt import gpt_block_fn, gpt_fused_boundary
from paddle_tpu_torch.models.gpt_hybrid import flatten_params
from paddle_tpu_torch.models.params import params_from_numpy, stage_params
from paddle_tpu_torch.distributed.recompute import remat
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import pp_boundary as ppb
from paddle_tpu_torch.optimizer import AdamW

# the reference's own pipeline test config (tests/test_pp_backend.py:67-73
# _mini), fp32
CFG_KW = dict(vocab_size=128, hidden_size=32, num_layers=8, num_heads=4,
              max_seq_len=32, use_flash=False, compute_dtype="float32",
              pp_schedule="gpipe")
M = 4                       # microbatches
SEQ_M = 8                   # microbatches of the 1F1B-vs-sequential case
STEPS = 5
LR = 1e-3
CLIP = 1.0
# (name, comm_backend, pp_schedule) of the step's rungs
RUNGS = (("ring-gpipe", "pp=ring", "gpipe"), ("ring-1f1b", "pp=ring", "1f1b"),
         ("fused", "pp=fused", "gpipe"))
# run_pipeline's variants: (name, schedule, backend)
PIPES = (("gpipe", "gpipe", "ring"), ("1f1b", "1f1b", "ring"),
         ("fused", "gpipe", "fused"))


def config(**kw):
    return GPTConfig(**{**CFG_KW, **kw})


def optimizer():
    return AdamW(LR, grad_clip=ClipGradByGlobalNorm(CLIP))


def _np(t):
    return t.detach().numpy().copy()


def pipeline(group, params, x, schedule, backend, layers=None,
             microbatches=M):
    """``run_pipeline`` on this stage's blocks (of the first ``layers``),
    loss = sum(out ** 2) on the last stage (the reference's test loss): the
    outputs (last stage), this stage's block gradients and, on stage 0,
    x's gradient."""
    cfg = config()
    if layers is not None:
        params = {**params, "blocks": {k: v[:layers] for k, v in
                                       params["blocks"].items()}}
    blocks = stage_params(params, group.rank, group.n)["blocks"]
    leaves = {k: v.clone().requires_grad_(True) for k, v in blocks.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    block = gpt_block_fn(cfg)
    kw = {}
    if schedule == "gpipe":
        block = remat(block, cfg.remat_policy)
    if backend == "fused":
        kw["boundary"] = gpt_fused_boundary(cfg, group, cfg.remat_policy)
    out = pl.run_pipeline(block, leaves, xt, microbatches, group,
                          schedule=schedule, backend=backend, **kw)
    last = group.rank == group.n - 1
    root = (out ** 2).sum() if last else out.sum()
    names = list(leaves)
    grads = torch.autograd.grad(root, [leaves[k] for k in names] + [xt],
                                allow_unused=True)
    return {"out": _np(out) if last else None,
            "loss": float(root) if last else None,
            "grads": {k: _np(g) for k, g in zip(names, grads)},
            "gx": None if grads[-1] is None else _np(grads[-1])}


def steps(group, params, ids, comm_backend, schedule, n_steps=STEPS):
    """``n_steps`` AdamW steps of the pipelined step: losses, the loss of
    ``loss_only`` before them, this stage's final leaves (numpy, flat
    names), and the pp counters against the step's own record."""
    pl.reset_pp_counters()
    step = HybridTrainStep(config(pp_schedule=schedule), optimizer(),
                           device="cpu", params=params, pp_group=group,
                           num_microbatches=M, comm_backend=comm_backend)
    before = float(step.loss_only(ids))
    losses = [float(step(ids)) for _ in range(n_steps)]
    rec = step._record(tuple(ids.shape))
    return {"losses": losses, "loss_only": before,
            "params": {k: _np(v) for k, v in
                       flatten_params(step.params).items()},
            "counters": pl.pp_counters(), "record": dataclasses.asdict(rec),
            "num_params": step.num_params()}


def flag_rungs(group, params, ids):
    """The rung and schedule the step takes from the flags: pp=fused named
    in FLAGS_comm_backend, and no pp rung named at all (ring with
    config.pp_schedule)."""
    out = {}
    for name, flag in (("fused", "pp=fused"), ("none", "mp=ring")):
        set_flags({"FLAGS_comm_backend": flag})
        try:
            step = HybridTrainStep(config(pp_schedule="1f1b"), optimizer(),
                                   device="cpu", params=params,
                                   pp_group=group, num_microbatches=M)
            out[name] = (step._ppc.backend, step._ppc.schedule,
                         float(step(ids)))
        finally:
            set_flags({"FLAGS_comm_backend": ""})
    return out


def wire_bf16(group, params, ids):
    """One ring step with FLAGS_pp_wire_dtype='bfloat16' (fp32 compute):
    its loss and boundary bytes."""
    set_flags({"FLAGS_pp_wire_dtype": "bfloat16"})
    try:
        res = steps(group, params, ids, "pp=ring", "gpipe", n_steps=1)
    finally:
        set_flags({"FLAGS_pp_wire_dtype": "auto"})
    return {"losses": res["losses"],
            "boundary_bytes": res["counters"]["boundary_bytes"]}


def checks(group, payload):
    """Everything a stage computes for the test module."""
    torch.set_num_threads(1)
    params = params_from_numpy(payload["params"], config(), device="cpu")
    ids = torch.from_numpy(payload["ids"])
    out = {"rank": group.rank,
           "pipes": {name: pipeline(group, params, payload["x"], sch, be)
                     for name, sch, be in PIPES},
           # the reference's own 1F1B-vs-sequential case
           # (tests/test_pp_backend.py:163-194): one layer a stage, M = 8
           "1f1b-seq": pipeline(group, params, payload["x"], "1f1b", "ring",
                                layers=group.n, microbatches=SEQ_M),
           "steps": {name: steps(group, params, ids, cb, sch)
                     for name, cb, sch in RUNGS}}
    out["flags"] = flag_rungs(group, params, ids)
    out["wire_bf16"] = wire_bf16(group, params, ids)
    return out


# rows 14-15 on the card: (R, K, F) per rank; not multiples of the
# 128-wide tiles in the first, several tiles in the second
CARD_SHAPES = ((48, 96, 80), (512, 1024, 256))


def card_kernels(group, seed):
    """On the card: rows 14 and 15 against their plain versions on this
    rank's inputs, and the boundary op's hop: rank r sends its y to r + 1,
    which must receive the same bytes. Returns [(case, readings, ok)],
    the launch counts and the hop checks."""
    dev = group.device
    g = torch.Generator(device=dev).manual_seed(seed + group.rank)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    ppb.reset_counts()
    readings, hops = [], []
    for R, K, F in CARD_SHAPES:
        x, r = rand(R, K), rand(R, F)
        w, b = rand(K, F, scale=K ** -0.5), rand(F)
        gy, gw = rand(R, F), rand(R, F)
        y = ppb.gemm_ppsend(x, w, b, r)
        dx, dw, db, dr = ppb.gemm_pprecv(gy, gw, x, w)
        pdx, pdw, pdb, pdr = ppb.gemm_pprecv_plain(gy, gw, x, w)
        torch.cuda.synchronize()
        for name, got, want in (("y", y, ppb.gemm_ppsend_plain(x, w, b, r)),
                                ("dx", dx, pdx), ("dw", dw, pdw)):
            rd = ppb.error_vs_plain(got, want)
            ok = bool(torch.isfinite(got).all()) and \
                got.shape == want.shape and \
                ppb.within_tolerance(rd, got.dtype)
            readings.append(((name, R, K, F), rd, ok))
        readings.append((("dr db", R, K, F), {},
                         torch.equal(dr, pdr) and torch.equal(db, pdb)))
        # the hop: y to the next rank, byte for byte
        pending = []
        y2 = ppb.fused_gemm_ppsend(x, w, b, r, group, pending.append) \
            if group.rank < group.n - 1 else y
        got = None
        if group.rank > 0:
            got, _ = group.stage_hops_async(
                recv_prev=((R, F), torch.bfloat16)).wait()
        for h in pending:
            h.wait()
        sent = group.all_gather_list(y2.contiguous())
        if got is not None:
            hops.append(torch.equal(got.view(torch.uint8),
                                    sent[group.rank - 1].view(torch.uint8)))
    counts = {k.__name__: (k.calls, k.launches) for k in ppb.KERNELS}
    return {"readings": readings, "counts": counts, "hops": hops}
