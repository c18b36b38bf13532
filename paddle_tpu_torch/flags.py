"""Runtime flags the port reads (counterpart of ``paddle_tpu/flags.py``).

Only the flags the ported slices read exist here (the serving defaults,
the tensor- and pipeline-parallel schedules and the data-parallel
gradient communication), with the reference's values; flags of later
slices are added with the code that reads them. ``set_flags`` refuses names it does not know, so a flag meant
for an unported feature cannot be set and silently ignored.
"""
from __future__ import annotations

_FLAGS = {
    # Decode slots: the fixed batch of the fused [B, 1] decode dispatch.
    "FLAGS_serving_slots": 8,
    # Sequence capacity per slot; 0 = the model's max_seq_len.
    "FLAGS_serving_max_seq_len": 0,
    # Wait-queue bound: submit raises QueueFullError past it.
    "FLAGS_serving_max_queue": 256,
    # KV layout; the port serves the paged layout only.
    "FLAGS_serving_kv_layout": "paged",
    # Tokens per KV page.
    "FLAGS_serving_page_size": 16,
    # Physical pages in the pool; 0 = num_slots * ceil(Smax / page) + 1.
    "FLAGS_serving_num_pages": 0,
    # Largest prefill chunk (tokens); the chunk ladder is the power-of-two
    # multiples of page_size up to it.
    "FLAGS_serving_prefill_chunk": 16,
    # Map cached prompt prefixes to shared pages (copy-on-write).
    "FLAGS_serving_prefix_cache": True,
    # Route one-token decode attention through the hand-written CUDA
    # kernel (serving/paged_decode.py) on CUDA tensors.
    "FLAGS_serving_paged_kernel": True,
    # Quantized serving (serving/quant.py): the stored dtype of the GEMM
    # weights and of the KV pages, "bf16" (full precision, none of the
    # quantized code runs), "int8" or "fp8".
    "FLAGS_serving_weight_dtype": "bf16",
    "FLAGS_serving_kv_dtype": "bf16",
    # Route quantized weight GEMMs through the hand-written CUDA kernel
    # (ops/quant_gemm.py) on CUDA tensors.
    "FLAGS_serving_quant_kernel": True,
    # Collective schedule per mesh axis, "axis=backend,..." or a bare
    # backend for every axis (distributed/comm_backend.py). Serving reads
    # the mp axis: "gspmd" (default), "ring" or "fused"; the training step
    # too (comm_backend.train_requested: "ring"/"fused" imply the
    # sequence-parallel layout); jit.TrainStep the dp axis
    # (grad_comm.resolve: "ring" or "fused" activate the explicit
    # gradient schedule, "gspmd" keeps the plain all-reduce).
    "FLAGS_comm_backend": "",
    # Training tensor parallelism: activations between blocks seq-sharded,
    # each block's all-reduces as reduce-scatter + all-gather ("rsag");
    # with FLAGS_mp_overlap, ring-decomposed ("ring").
    "FLAGS_sequence_parallel": False,
    "FLAGS_mp_overlap": False,
    # Pipeline boundary wire dtype of the explicit pp schedule
    # (comm_backend.resolve_pp): "auto" (the compute dtype), "float32" or
    # "bfloat16"; the fused rung ignores it.
    "FLAGS_pp_wire_dtype": "auto",
    # Explicit data-parallel gradient communication of jit.TrainStep
    # (distributed/grad_comm.py): "auto" (on when weight-update sharding
    # or a compressed wire asks for it, or FLAGS_comm_backend names
    # dp=ring/fused), True/"on" or False/"off".
    "FLAGS_grad_comm": "auto",
    # Reduce-scatter the gradients, update each replica's 1/n flat shard
    # (optimizer slots stored packed), all-gather the params.
    "FLAGS_weight_update_sharding": False,
    # Wire dtype of the gradient reduction: "float32", "bfloat16" or
    # "int8" (per-chunk scales); accumulation stays fp32.
    "FLAGS_allreduce_dtype": "float32",
    # Target bytes of one gradient bucket (same-dtype params packed
    # along columns).
    "FLAGS_grad_bucket_bytes": 16 * 2 ** 20,
}


def set_flags(flags: dict):
    unknown = sorted(k for k in flags if k not in _FLAGS)
    if unknown:
        raise KeyError(f"unknown flag(s) {unknown}; the port knows "
                       f"{sorted(_FLAGS)}")
    _FLAGS.update(flags)


def get_flags(flags=None):
    if flags is None:
        return dict(_FLAGS)
    if isinstance(flags, str):
        flags = [flags]
    return {k: _FLAGS.get(k) for k in flags}
