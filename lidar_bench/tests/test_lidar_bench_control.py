"""The control on the card: the reference in the program's place with TF32
matrix products must come out not correct, where the port comes out
correct. At the tiny size, three seeds; the readings at the cells' own
size come from lidar_bench/control.py (PERF.md)."""
from __future__ import annotations

import time

import pytest
import torch

from lidar_bench.harness import cell, programs, spec
from lidar_bench.tests.conftest import SEED


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cell_plane.stream-urban", "cell_plane.batch64-urban"])
def test_the_control_fails_where_the_port_passes(tiny_bench, name):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products exist only on a CUDA device")
    config = spec.config(spec.workload(spec.benchmark(), name)["config"], tiny_bench)
    for seed in (SEED, SEED + 1, SEED + 2):
        sound = cell.run(name, seed, 3.0, False, "cuda", time.perf_counter(), processes=1, bench_dir=tiny_bench)
        control = cell.run(name, seed, 3.0, False, "cuda", time.perf_counter(), processes=1,
                           program=programs.reference(config), control=True, bench_dir=tiny_bench)
        assert sound["correct"], sound["check"]
        assert not control["correct"], control["check"]
