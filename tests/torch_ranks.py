"""The rank side of the port's distributed tests.

``run_group`` spawns one process per rank of a gloo group on the CPU (a
``FileStore`` in a scratch directory: no port, no network) and runs a list
of cases in every rank, in order; each rank hands back its results.  The
spawned processes import this module by name, so it imports nothing of JAX
and nothing of ``spada_tpu``: the test files compute the JAX side in the
pytest process and pass NumPy and the port's host objects in.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: per-collective limit: a rank that waits longer raises instead of hanging
COLLECTIVE_TIMEOUT_S = 60


def run_group(world: int, cases, workdir, timeout: float = 300.0) -> dict:
    """Run ``cases`` ([(key, function name in this module, kwargs)]) in a
    spawned gloo group of ``world`` ranks.  Returns {key: [each rank's
    result]}; a case that raised in a rank gives ``RankError`` there."""
    workdir = str(workdir)
    # the cases go through a file: spawn writes a process's arguments into
    # a pipe that the child reads only after its imports, so large
    # arguments would start the ranks one after another
    with open(os.path.join(workdir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    ctx = mp.start_processes(_rank_main, args=(world, workdir), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    results = [os.path.join(workdir, f"rank{r}.pkl") for r in range(world)]
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a {world}-rank group ran past "
                                   f"{timeout} s")
    except mp.ProcessExitedException:
        # a rank that wrote its results and then died in the gloo teardown
        # has done its work; one that died before has not
        if not all(os.path.exists(p) for p in results):
            raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = {key: [] for key, _, _ in cases}
    for path in results:
        with open(path, "rb") as f:
            res = pickle.load(f)
        for key in out:
            out[key].append(res[key])
    return out


class RankError:
    """A case that raised in a rank, with its traceback."""

    def __init__(self, text: str):
        self.text = text

    def __repr__(self):
        return f"RankError({self.text})"


def _rank_main(rank: int, world: int, workdir: str):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    store = os.path.join(workdir, "store")
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    results = {}
    try:
        for key, fn, kwargs in cases:
            try:
                results[key] = globals()[fn](**kwargs)
            except Exception:
                results[key] = RankError(traceback.format_exc())
            loaded = sorted(m for m in sys.modules if m in ("jax", "jaxlib")
                            or m == "spada_tpu" or m.startswith("spada_tpu."))
            if loaded:
                results[key] = RankError(f"the rank loaded {loaded}")
    finally:
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        # no rank tears its connections down while another still uses them
        dist.barrier()
        dist.destroy_process_group()


def _dtype(name):
    return None if name is None else getattr(torch, name)


# --------------------------------------------------------------------------
# cases
# --------------------------------------------------------------------------

def sharded(problem, runs, mesh_shape=None):
    """``spgemm_sharded`` under each (engine, dtype name, merge) of
    ``runs``: {run: C tiles}.  ``mesh_shape``: build the mesh here and pass
    it, instead of ``mesh=None``."""
    from spada_tpu_torch.parallel import spgemm_sharded
    from spada_tpu_torch.parallel.mesh import resolve_mesh

    mesh = None
    if mesh_shape is not None:
        mesh = resolve_mesh(None, mesh_shape, ("dp", "tp"),
                            torch.device("cpu"))
    return {run: spgemm_sharded(problem, mesh=mesh, device="cpu",
                                engine=run[0], engine_dtype=_dtype(run[1]),
                                merge=run[2]).c_tiles
            for run in runs}


def sharded_csr(problem):
    """``spgemm_sharded(...).to_csr()`` as (indptr, indices, data)."""
    from spada_tpu_torch.parallel import spgemm_sharded

    c = spgemm_sharded(problem, device="cpu", engine="xla").to_csr()
    return c.indptr, c.indices, c.data


def halo(problem, runs):
    """``spgemm_halo`` under each (engine, dtype name): {run: C tiles}."""
    from spada_tpu_torch.parallel import spgemm_halo

    return {run: spgemm_halo(problem, device="cpu", engine=run[0],
                             engine_dtype=_dtype(run[1])).c_tiles
            for run in runs}


def element(problem, backends):
    """``spgemm_element_dp`` under each backend: {backend: the per-class
    values}, and under 'collectives' the calls on torch.distributed that
    each backend's rank body made, and that the entry point made."""
    from spada_tpu_torch.parallel import spgemm_element_dp
    from spada_tpu_torch.parallel.element_dp import element_rank
    from spada_tpu_torch.parallel.mesh import resolve_mesh

    mesh = resolve_mesh(None, (problem.n_dev,), ("dp",), torch.device("cpu"))
    (rank,) = mesh.get_coordinate()
    out, calls = {}, {}
    for backend in backends:
        with _count_collectives() as n:
            element_rank(problem, rank, "cpu", backend)()
        calls[f"body {backend}"] = dict(n)
        with _count_collectives() as n:
            res = spgemm_element_dp(problem, mesh=mesh, device="cpu",
                                    backend=backend)
        calls[f"entry {backend}"] = dict(n)
        out[backend] = res.values
    out["collectives"] = calls
    return out


#: the collectives and point-to-point calls of torch.distributed
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "broadcast", "broadcast_object_list", "reduce", "gather",
                "scatter", "barrier", "send", "recv", "isend", "irecv",
                "batch_isend_irecv")


class _count_collectives:
    """Counts, by name, the calls on torch.distributed's collectives inside
    the block."""

    def __enter__(self):
        self.counts, self.saved = {}, {}
        for name in _COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn

            def counted(*args, _name=name, _fn=fn, **kw):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*args, **kw)

            setattr(dist, name, counted)
        return self.counts

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)
        return False


def mesh_mismatch(problem):
    """The error ``spgemm_sharded`` raises when the world is not the
    problem's rank count."""
    from spada_tpu_torch.parallel import spgemm_sharded

    try:
        spgemm_sharded(problem, device="cpu", engine="xla")
    except ValueError as err:
        return str(err)
    return None


def mlp(specs, params, mesh_shape, lr, x, y, steps):
    """``make_sharded_train_step`` for ``steps`` steps: (this rank's
    (d, t), its shard params after the steps, the losses)."""
    from spada_tpu_torch.models.sparse_nn import (SparseMLP,
                                                  make_sharded_train_step)
    from spada_tpu_torch.parallel.mesh import resolve_mesh

    model = SparseMLP(specs, params, device="cpu")
    mesh = resolve_mesh(None, mesh_shape, ("dp", "tp"), torch.device("cpu"))
    step, sp = make_sharded_train_step(model, mesh, lr=lr)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(steps):
        sp, loss = step(sp, x, y)
        losses.append(float(loss))
    return (tuple(mesh.get_coordinate()),
            [np.asarray(p.detach().numpy()) for p in sp], losses)
