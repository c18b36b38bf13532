"""Distributed pieces of the port (counterpart of
``paddle_tpu/distributed``): activation recomputation for the training
step (``recompute``), and tensor and pipeline parallelism over
``torch.distributed``: process groups, stage hops and the rank launcher
(``env``), the serving and the sequence-parallel training mp schedules
(``tp_overlap``), the explicit GPipe and 1F1B pipeline schedules and
their ledger (``pipeline``) and the ``FLAGS_comm_backend`` rungs
(``comm_backend``). The data-parallel layer is ROADMAP Queue A item 11,
step 2."""
