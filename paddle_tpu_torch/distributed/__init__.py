"""Distributed pieces of the port (counterpart of
``paddle_tpu/distributed``): activation recomputation for the training
step (``recompute``), and tensor, pipeline and data parallelism over
``torch.distributed``: process groups, per-axis sub-groups of a hybrid
world, stage hops and the rank launcher (``env``), the serving and the
sequence-parallel training mp schedules (``tp_overlap``), the explicit
GPipe and 1F1B pipeline schedules and their ledger (``pipeline``), the
data-parallel gradient communication (``grad_comm``), the peer-memory
channels (``peer``) and the ``FLAGS_comm_backend`` rungs
(``comm_backend``)."""
