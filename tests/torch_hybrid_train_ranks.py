"""Per-rank functions of tests/test_torch_hybrid_train.py, run by
``paddle_tpu_torch.distributed.env.launch(..., axes=)`` in spawned ranks
of a hybrid world on the CPU (gloo), each rank in one sub-group per axis.
A spawned child imports the module that holds its function, so this
module imports neither jax nor the reference package: the JAX side runs
in the test process and arrives here as numpy."""
import torch

from paddle_tpu_torch.distributed import grad_comm as gc
from paddle_tpu_torch.models import GPTConfig, HybridTrainStep
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.models.gpt_hybrid import flatten_params
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

# the reference's tensor-parallel test config (tests/test_tp_overlap.py
# _mini_cfg, as tests/torch_tp_train_ranks.py runs it) at 4 layers, so
# that two stages hold two layers each
CFG_KW = dict(vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
              max_seq_len=64, dropout=0.0, use_flash=False,
              compute_dtype="float32", remat=True)
M = 2                       # microbatches
STEPS = 5
# a fused run is held to its ring run's bits: its first steps suffice
FUSED_STEPS = 2
LR = 1e-3
CLIP = 1.0
# layout -> (axes, global batch, runs); a run is (name, comm_backend,
# pp_schedule, ZeRO-1 over dp)
LAYOUTS = {
    "dp2xmp2": ({"dp": 2, "mp": 2, "pp": 1}, 4, (
        ("ring", "mp=ring,dp=ring", None, True),
        ("fused", "mp=fused,dp=fused", None, True),
        ("no-zero", "mp=ring", None, False))),
    "dp2xpp2": ({"dp": 2, "mp": 1, "pp": 2}, 4, (
        ("ring", "pp=ring,dp=ring", "gpipe", True),
        ("fused", "pp=fused,dp=fused", "gpipe", True),
        ("no-zero", "pp=ring", "gpipe", False))),
    "pp2xmp2": ({"dp": 1, "mp": 2, "pp": 2}, 4, (
        ("ring", "mp=ring,pp=ring", "gpipe", False),
        ("fused", "mp=fused,pp=ring", "gpipe", False),
        ("ring-1f1b", "mp=ring,pp=ring", "1f1b", False))),
    # the reference's own multi-chip composition (__graft_entry__.py:80-96:
    # its default 1F1B, ZeRO-1 over dp; also dp x pp's 1F1B)
    "pp2xdp2xmp2": ({"dp": 2, "mp": 2, "pp": 2}, 8, (
        ("ring-1f1b", "mp=ring,pp=ring,dp=ring", "1f1b", True),)),
}


def config(**kw):
    return GPTConfig(**{**CFG_KW, **kw})


def optimizer(zero=False):
    opt = AdamW(LR, grad_clip=ClipGradByGlobalNorm(CLIP))
    if zero:
        opt._shard_opt_states_axis = "dp"     # as __graft_entry__.py:63
    return opt


def _np(t):
    return t.detach().numpy().copy()


def steps(name):
    """The steps run ``name`` takes."""
    return FUSED_STEPS if name == "fused" else STEPS


def _leaves(step):
    return {k: _np(v) for k, v in flatten_params(step.params).items()}


def run(groups, params, ids, comm_backend, schedule, zero, n_steps,
        grads=False):
    """``n_steps`` steps of the composed step: the losses, ``loss_only``
    before them, this rank's final leaves (numpy, flat names) and those
    after ``FUSED_STEPS`` steps, the optimizer's slot shapes, the dp
    record's rung and, with ``grads``, this rank's gradients at the
    initial params (``loss_and_grads``)."""
    cfg = config() if schedule is None else config(pp_schedule=schedule)
    step = HybridTrainStep(cfg, optimizer(zero), device="cpu",
                           params=params, group=groups.mp,
                           pp_group=groups.pp, dp_group=groups.dp,
                           num_microbatches=M, comm_backend=comm_backend)
    first = None
    if grads:
        _, g = step.loss_and_grads(ids)
        first = {k: _np(v) for k, v in g.items()}
    before = float(step.loss_only(ids))
    losses, early = [], None
    for i in range(n_steps):
        losses.append(float(step(ids)))
        if i + 1 == FUSED_STEPS:
            early = _leaves(step)
    dp = step.step_records(tuple(ids.shape))["dp"]
    slots = {k: tuple(v["moment1"].shape)
             for k, v in step.opt_state["slots"].items()}
    return {"losses": losses, "loss_only": before, "params": _leaves(step),
            "early": early, "slots": slots,
            "dp_backend": None if dp is None else dp.backend,
            "num_params": step.num_params(), "grads": first}


def checks(groups, payload, layout):
    """Every run of ``layout`` on this rank, with its coordinates."""
    torch.set_num_threads(1)
    gc.reset_comm_counters()
    params = params_from_numpy(payload["params"], config(), device="cpu")
    ids = torch.from_numpy(payload["ids"][layout])
    _, _, runs = LAYOUTS[layout]
    out = {"rank": groups.rank,
           "coords": {a: getattr(groups, a).rank for a in ("dp", "mp", "pp")},
           "runs": {name: run(groups, params, ids, cb, sched, zero,
                              steps(name), grads=i == 0)
                    for i, (name, cb, sched, zero) in enumerate(runs)}}
    out["comm_steps"] = gc.comm_counters()["steps"]
    return out
