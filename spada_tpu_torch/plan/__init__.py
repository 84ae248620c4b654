"""Host planning (copies of :mod:`spada_tpu.plan`) and plan execution on
PyTorch (:mod:`spada_tpu_torch.plan.execute`)."""
