"""Distributed pieces of the port (counterpart of
``paddle_tpu/distributed``): activation recomputation for the
single-device training step (``recompute``) and tensor-parallel serving
over ``torch.distributed``: process groups and the rank launcher
(``env``), the serving mp schedule (``tp_overlap``) and the
``FLAGS_comm_backend`` rungs (``comm_backend``). The training
tensor-parallel, data-parallel and pipeline layers are ROADMAP Queue A
item 11."""
