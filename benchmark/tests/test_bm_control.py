"""The control: the plain reference in the program's place with its
matrix products one precision step down (float8 e4m3 for the bf16
towers) reads at least three times what the program reads, on three seeds, at
a tiny size where the program's towers run in float32 (at this size
bf16's own rounding flips decisions). The readings at the cells' own
size, which set the limits, come from `python3 -m benchmark.control
readings` on the chip (PERF.md)."""

import pytest

from benchmark import control
from benchmark.tests.tiny import tiny_bench

# seeds whose tiny models emit
CELLS = {"stream-greedy-backlog": (dict(bias=17.0, gain=16.0, compute="float32"),
                                   (32, 35, 38)),
         "stream-beam4lm-backlog": (dict(bias=14.0, gain=16.0, compute="float32"),
                                    (32, 35, 43))}
NUMBER = {"stream-greedy-backlog": "gap", "stream-beam4lm-backlog": "mismatch"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_reads_above_the_program(cell):
    prog, ctrl = [], []
    kw, seeds = CELLS[cell]
    for seed in seeds:
        r = control.readings(tiny_bench(cell, seed, **kw), 4.0)
        assert not r["faults"]
        prog.append(r["program"][NUMBER[cell]])
        ctrl.append(r["control"][NUMBER[cell]])
    assert min(ctrl) > 0 and min(ctrl) >= 3 * max(prog), (prog, ctrl)
