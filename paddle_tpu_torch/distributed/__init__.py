"""Distributed pieces of the port (counterpart of
``paddle_tpu/distributed``): activation recomputation for the training
step (``recompute``) and tensor parallelism over ``torch.distributed``:
process groups and the rank launcher (``env``), the serving and the
sequence-parallel training mp schedules (``tp_overlap``) and the
``FLAGS_comm_backend`` rungs (``comm_backend``). The data-parallel and
pipeline layers are ROADMAP Queue A item 11."""
