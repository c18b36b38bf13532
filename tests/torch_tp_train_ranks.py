"""Per-rank functions of tests/test_torch_tp_train.py, run by
``paddle_tpu_torch.distributed.env.launch`` in spawned ranks on the CPU
(gloo). A spawned child imports the module that holds its function, so
this module imports neither jax nor the reference package: the JAX side
runs in the test process and arrives here as numpy."""
import torch

from paddle_tpu_torch.distributed import tp_overlap as tp
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.models import GPTConfig, HybridTrainStep
from paddle_tpu_torch.models.gpt_hybrid import flatten_params
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import fused_collectives as fc
from paddle_tpu_torch.ops import ring_gemm as rg
from paddle_tpu_torch.optimizer import AdamW

# the reference's own tensor-parallel test config (tests/test_tp_overlap.py
# _mini_cfg), run at B=4, S=32
CFG_KW = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=64, dropout=0.0, use_flash=False,
              compute_dtype="float32", remat=True)
RUNGS = ("rsag", "ring", "fused")
STEPS = 5
LR = 1e-3
CLIP = 1.0


def config():
    return GPTConfig(**CFG_KW)


def optimizer():
    return AdamW(LR, grad_clip=ClipGradByGlobalNorm(CLIP))


def _np(t):
    return t.detach().numpy().copy()


def _rows(t, group, n_dim=1):
    """This rank's 1/n block of ``t`` along ``n_dim``."""
    w = t.shape[n_dim] // group.n
    return t.narrow(n_dim, group.rank * w, w).contiguous()


def _grads(fn, inputs, cot):
    """(out, d inputs) of ``fn(*inputs)`` against the cotangent ``cot``."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, cot)


def ops(group, case):
    """The three rungs of the all-gather + GEMM and the GEMM +
    reduce-scatter on this rank's shards of ``case`` (x [B, S, A], w
    [A, F], y [B, S, F], w2 [F, A], cotangents gy [B, S, F] and gx
    [B, S, A], all fp32): forward, and dx, dw by autograd; and the ring
    weight-gradient kernel's plain version."""
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    x_r = _rows(t["x"], group)                  # seq shard
    w_r = _rows(t["w"], group)                  # column shard
    y_r = _rows(t["y"], group, 2)               # feature-sharded partial
    w2_r = _rows(t["w2"], group, 0)             # row shard
    gy_r = _rows(t["gy"], group, 2)             # [B, S, F/n]
    gx_r = _rows(t["gx"], group)                # [B, s, A]
    out = {}
    ag = {"fused": lambda x, w: fc.fused_ag_gemm(x, w, group),
          "ring": lambda x, w: tp.ring_ag_gemm(x, w, group),
          "rsag": lambda x, w: tp.seq_all_gather(x, group) @ w}
    rs = {"fused": lambda y, w: fc.fused_gemm_rs(y, w, group),
          "ring": lambda y, w: tp.gemm_ring_rs(y, w, group),
          "rsag": lambda y, w: tp.seq_reduce_scatter(y @ w, group)}
    for rung in RUNGS:
        o, (dx, dw) = _grads(ag[rung], (x_r, w_r), gy_r)
        out[f"ag/{rung}"] = (_np(o), _np(dx), _np(dw))
        o, (dy, dw2) = _grads(rs[rung], (y_r, w2_r), gx_r)
        out[f"rs/{rung}"] = (_np(o), _np(dy), _np(dw2))
    out["ag/plain"] = _np(rg.ring_ag_gemm(x_r, w_r, group))
    out["rs/plain"] = _np(rg.ring_gemm_rs(y_r, w2_r, group))
    out["accum"] = _np(rg.ring_ag_accum(x_r, gy_r, group))
    out["accum_t"] = _np(rg.ring_ag_accum(gx_r, y_r, group,
                                          transpose=True))
    return out


def steps(group, params, ids, rung):
    """STEPS steps of the tensor-parallel step on ``rung``: the losses,
    this rank's final shards (numpy, flat names), and the mp counters
    against the step's own record."""
    tp.reset_mp_counters()
    step = HybridTrainStep(config(), optimizer(), device="cpu",
                           params=params, group=group, comm_backend=rung)
    before = float(step.loss_only(ids))
    losses = [float(step(ids)) for _ in range(STEPS)]
    rec = step._record(tuple(ids.shape))
    return {"losses": losses, "loss_only": before,
            "shards": {k: _np(v) for k, v in
                       flatten_params(step.params).items()},
            "counters": tp.mp_counters(),
            "record": {k: getattr(rec, k) for k in (
                "collectives", "ppermute_hops", "fused_dispatches",
                "rs_bytes", "ag_bytes", "activation_bytes")},
            "num_params": step.num_params()}


def flag_rung(group, params, ids):
    """One step whose rung comes from FLAGS_comm_backend (mp=fused)."""
    set_flags({"FLAGS_comm_backend": "mp=fused"})
    try:
        step = HybridTrainStep(config(), optimizer(), device="cpu",
                               params=params, group=group)
        return step._backend(), float(step(ids))
    finally:
        set_flags({"FLAGS_comm_backend": ""})


def checks(group, payload):
    """Everything a rank computes for the test module."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.models import params_from_numpy
    params = params_from_numpy(payload["params"], config(), device="cpu")
    ids = torch.from_numpy(payload["ids"])
    out = {"rank": group.rank, "ops": ops(group, payload["case"])}
    out["steps"] = {rung: steps(group, params, ids, rung)
                    for rung in RUNGS}
    out["flag_rung"] = flag_rung(group, params, ids)
    return out


# the ring kernels' card check: (B, s, A, F) per rank; A and F not
# multiples of the 128-wide tiles in the first, several tiles in the second
CARD_SHAPES = ((2, 24, 96, 48), (2, 256, 512, 384))


def card_kernels(group, seed):
    """On the card: each ring kernel, plain and transposed, against its
    plain version on this rank's inputs; returns [(case, readings, ok)]
    and the launch counts."""
    dev = group.device
    g = torch.Generator(device=dev).manual_seed(seed + group.rank)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rg.reset_counts()
    out = []
    for B, s, A, Fd in CARD_SHAPES:
        S = group.n * s
        x, gx = rand(B, s, A), rand(B, s, A)
        y, gy = rand(B, S, Fd), rand(B, S, Fd)
        w, w2 = rand(A, Fd), rand(Fd, A)
        cases = {
            "ag_gemm": (rg.ring_ag_gemm(x, w, group),
                        rg.ag_gemm_plain(x, w, group)),
            "ag_gemm_t": (rg.ring_ag_gemm(gx, w2, group, transpose_w=True),
                          rg.ag_gemm_plain(gx, w2, group, True)),
            "gemm_rs": (rg.ring_gemm_rs(y, w2, group),
                        rg.gemm_rs_plain(y, w2, group)),
            "gemm_rs_t": (rg.ring_gemm_rs(gy, w, group, transpose_w=True),
                          rg.gemm_rs_plain(gy, w, group, True)),
            "ag_accum": (rg.ring_ag_accum(x, gy, group),
                         rg.ag_accum_plain(x, gy, group)),
            "ag_accum_t": (rg.ring_ag_accum(gx, y, group, transpose=True),
                           rg.ag_accum_plain(gx, y, group, True)),
        }
        torch.cuda.synchronize()
        for name, (got, want) in cases.items():
            r = rg.error_vs_plain(got, want)
            ok = bool(torch.isfinite(got).all()) and \
                got.shape == want.shape and got.dtype == want.dtype and \
                rg.within_tolerance(r, got.dtype)
            out.append(((name, B, s, A, Fd), r, ok))
    counts = {k.__name__: (k.calls, k.launches) for k in rg.KERNELS}
    return {"readings": out, "counts": counts}
