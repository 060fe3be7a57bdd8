"""The two sides a cell runs: the port under test and the plain reference.

Both are bound to the same few names, so the drivers run either one: a
run drives the port, the check drives the reference over the same scans,
and the control drives the reference in the program's place at a lower
precision. The port is ``tloam_torch``; nothing here imports the JAX
package.

The reference is the package under ``lidar_bench/`` that the cell's
configuration names by its ``"reference"`` key, or ``reference/`` (the
frozen copy of the port's frame path) where it names none. Such a piece
has the modules ``frontend``, ``cloud``, ``config`` and ``registration``,
each a file of its own or bound in its ``__init__.py`` (an unchanged
module of ``lidar_bench.reference``, say).
"""
from __future__ import annotations

import contextlib
import importlib
import inspect
from typing import Any, NamedTuple

import torch


class Program(NamedTuple):
    name: str
    frontend: Any  # init_state, odometry_step_packed, preprocess_frame, submap_features, odometry_step
    Cloud: Any  # pack_scan, from_packed
    stack_tensors: Any
    solve: Any  # (scans, submaps, predict_poses, tls) with a leading batch -> (poses, Diagnostics)
    load_config: Any  # (path, overrides) -> PipelineConfig
    stages: Any = None  # the program's stage timer (enable/collect), where it has one
    edge_picks: int | None = None  # picks a sector of the edge kernel's call


def port(device) -> Program:
    """tloam_torch, its CUDA kernels built (into build/tloam_torch/ inside
    the checkout) when the run is on the card."""
    from tloam_torch import build
    from tloam_torch.cloud import Cloud, stack_tensors
    from tloam_torch.config import load_pipeline_config
    from tloam_torch.models import edge
    from tloam_torch.parallel.batched import vmap_scan_matching
    from tloam_torch.pipeline import frontend
    from tloam_torch.utils.timing import STAGES

    if torch.device(device).type == "cuda":
        build.build(build.KERNELS)
    picks = inspect.signature(edge.extract_edges).parameters["picks_per_sector"].default
    return Program("tloam_torch", frontend, Cloud, stack_tensors, vmap_scan_matching, load_pipeline_config,
                   STAGES, picks)


DEFAULT_REFERENCE = "reference"


def reference(config: dict | None = None) -> Program:
    """The plain reference that `config` names (see above). A name that
    does not resolve to a package with every module and name the drivers
    call raises a ValueError that names it; nothing falls back."""
    name = (config or {}).get("reference", DEFAULT_REFERENCE)
    where = f"reference piece {name!r} (lidar_bench/{name}/)"
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"{where}: not a package name")
    try:
        pkg = importlib.import_module(f"lidar_bench.{name}")
        mods = {m: getattr(pkg, m, None) or importlib.import_module(f"{pkg.__name__}.{m}")
                for m in ("frontend", "cloud", "config", "registration")}
        return Program(name, mods["frontend"], mods["cloud"].Cloud, mods["cloud"].stack_tensors,
                       mods["registration"].scan_matching, mods["config"].load_pipeline_config)
    except (ImportError, AttributeError) as e:
        raise ValueError(f"{where} does not resolve: {e}") from e


def pipeline_config(prog: Program, config: dict):
    """The configuration file's PipelineConfig overrides applied to the
    program's defaults."""
    return prog.load_config(None, [f"{k}={v}" for k, v in config["overrides"].items()])


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products and convolutions in full float32 (the
    configurations' precision), or in TF32 (the control's)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
