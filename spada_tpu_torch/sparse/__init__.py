"""Copy of :mod:`spada_tpu.sparse`
for spada_tpu_torch, held equal to it by ``tests/test_torch_host.py``; only
the imports differ."""
from spada_tpu_torch.sparse.csr import CsrMatrix
from spada_tpu_torch.sparse.bsr import BsrMatrix, BsrValueMap, tiles_of_csr

__all__ = ["CsrMatrix", "BsrMatrix", "BsrValueMap", "tiles_of_csr"]
