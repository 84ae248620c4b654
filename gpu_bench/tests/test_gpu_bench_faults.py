"""A run is judged correct, and its control and each fault its timed path
can have come out not correct: each cell at a tiny size on the CPU, where the
port's kernels run their plain versions, the harness driven past its look
for a card.  One card, so no exchange between cards can be left out."""

import pytest
import torch

from gpu_bench import harness
from gpu_bench.cells import load_benchmark, load_cell

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
#: each cell cut to a size a test can hold, on the side its plan takes
TINY = {
    "opt-1.3b-fc2-blk32.prefill-16k": (
        {"hidden_size": 256, "ffn_dim": 1024}, {"tokens": 2048}, "tile"),
    "graph500-s14-sym.a2-reuse": ({"scale": 9}, {}, "element"),
}
CPU = torch.device("cpu")


def _run(name, seed=3, control=False):
    config, traffic, side = TINY[name]
    cell = load_cell(name)
    cell.config.update(config)
    cell.traffic.update(traffic)
    inputs = harness.make_inputs(cell, seed)
    run = harness.plan_cell(cell, inputs, CPU, lambda msg: None)
    assert run.choice == side
    return harness.measure(cell, inputs, run, seed, 0.02, CPU,
                           control=control)


def test_every_cell_has_a_tiny_size():
    assert set(CELLS) == set(TINY)


@pytest.mark.parametrize("seed", [3, 2**35 + 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, seed):
    out = _run(name, seed)
    assert out["correct"] and out["failed"] == 0
    assert out["judged"] == 3
    assert out["compared"]["max_rel_err"]["value"] < 1e-6


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The port's lower precision: bf16 tiles, bf16 element operands."""
    out = _run(name, control=True)
    assert not out["correct"]
    value = out["compared"]["max_rel_err"]
    assert value["value"] > 30 * value["limit"]


def _unchanged(orig):
    first = []

    def fault(*args, **kw):
        if not first:
            first.append(orig(*args, **kw))
        return first[0]

    return fault


def _tile_half(orig):
    from spada_tpu_torch.ops import engine

    def fault(a_tiles, b_tiles, a_tid, b_tid, tile_ptr):
        w = a_tid.shape[0]
        o = engine._run_o_ids(tile_ptr, w)
        keep = torch.arange(w) % 2 == 0
        return 2 * engine.run_worklist_reference(
            a_tiles, b_tiles, a_tid[keep], b_tid[keep], o[keep],
            int(tile_ptr.shape[0]) - 1)

    return fault


def _element_half(orig):
    def fault(*args, **kw):
        outs = orig(*args, **kw)
        for v in outs:
            flat = v.view(-1)
            flat[1::2] = 0
            flat[0::2] *= 2
        return outs

    return fault


def _tile_altered(orig):
    def fault(*args, **kw):
        c = orig(*args, **kw)
        c[0, 0, 0] += 1.0
        return c

    return fault


def _element_altered(orig):
    def fault(*args, **kw):
        outs = orig(*args, **kw)
        outs[0].view(-1)[0] += 1.0
        return outs

    return fault


FAULTS = {
    "state returned unchanged": {"tile": _unchanged, "element": _unchanged},
    "half the batch left out, the mean over the rest": {
        "tile": _tile_half, "element": _element_half},
    "an answer altered where it is produced": {
        "tile": _tile_altered, "element": _element_altered},
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    from spada_tpu_torch.ops import element_stream, engine

    side = TINY[name][2]
    module, attr = ((engine, "tile_spgemm") if side == "tile"
                    else (element_stream, "esc_stream_group"))
    monkeypatch.setattr(module, attr, FAULTS[fault][side](
        getattr(module, attr)))
    out = _run(name)
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_and_control_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from gpu_bench import control

    config, traffic, _ = TINY[name]
    cell = load_cell(name)
    cell.config.update(config)
    cell.traffic.update(traffic)
    got = control.readings(cell, [5], {5}, 0.05, torch.device("cuda"),
                           log=lambda msg: None)
    limit = cell.config["limits"]["max_rel_err"]
    assert got["program"][5]["max_rel_err"] <= limit
    assert got["control"][5]["max_rel_err"] > limit
