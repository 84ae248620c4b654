"""Host models of the port: the functional traffic model and the NN
workload generator (copies of :mod:`spada_tpu.models.traffic` and
:mod:`spada_tpu.models.nn_workloads`)."""
