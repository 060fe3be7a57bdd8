"""The PyTorch port (tloam_torch) against the JAX package: shared helpers,
the config/utility copies, the import guard and the no-GPU behaviour.

Every parity test feeds both implementations the same float32 numpy inputs
(this suite turns on jax_enable_x64, so JAX inputs are made float32
explicitly) and runs the port on the CPU."""
import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tloam_torch
from tloam_torch import config as tcfg
from tloam_torch.cloud import Cloud as TCloud
from tloam_torch.utils import synthetic as tsyn, trajectory as ttraj

from tloam_tpu import config as jcfg
from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.pipeline import frontend as jfront
from tloam_tpu.utils import synthetic as jsyn, trajectory as jtraj

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def tt(a, dtype=None) -> torch.Tensor:
    """numpy/JAX array -> CPU torch tensor (float arrays stay float32)."""
    a = np.array(a)  # a writable copy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def jcloud_to_torch(c) -> TCloud:
    return TCloud(tt(c.xyz), tt(c.intensity), tt(c.valid))


def np_of(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def small_scan(i: int = 0, rings: int = 24, az: int = 768, seed: int = 5, step: float = 0.6):
    scene = jsyn.Scene.urban(np.random.default_rng(seed))
    gt = jsyn.straight_trajectory(i + 1, step=step)
    return jsyn.simulate_scan(gt[i], scene, rings=rings, az_steps=az, rng=np.random.default_rng(i), noise=0.005)


def clouds_from_numpy(xyz, inten, cap):
    return (
        JCloud.from_numpy(f32(xyz), f32(inten), capacity=cap, dtype=jnp.float32),
        TCloud.from_numpy(f32(xyz), f32(inten), capacity=cap, device="cpu"),
    )


# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name",
    ["SensorConfig", "GroundSegConfig", "DCVCConfig", "FeatureConfig", "TLSConfig",
     "OdometryConfig", "DataConfig", "PipelineConfig"],
)
def test_config_copies_match_field_for_field(name):
    jc = jfront.PipelineConfig if name == "PipelineConfig" else getattr(jcfg, name)
    tc = getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tc)]
    assert jf == tf
    assert dataclasses.asdict(jc()) == dataclasses.asdict(tc())
    if name == "PipelineConfig":
        assert tc().frame_planar_total == jc().frame_planar_total


def _code(path) -> str:
    """A module's syntax tree without its docstring."""
    tree = ast.parse(Path(path).read_text())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


def test_synthetic_and_trajectory_copies_identical():
    for mod_t, mod_j in ((tsyn, jsyn), (ttraj, jtraj)):
        assert _code(mod_t.__file__) == _code(mod_j.__file__)
    scene = tsyn.Scene.urban(np.random.default_rng(3), extent=40.0)
    gt = tsyn.straight_trajectory(3, step=1.0, yaw_rate=0.005)
    a = tsyn.simulate_scan(gt[1], scene, rings=16, az_steps=256, rng=np.random.default_rng(1), noise=0.01)
    scene_j = jsyn.Scene.urban(np.random.default_rng(3), extent=40.0)
    b = jsyn.simulate_scan(gt[1], scene_j, rings=16, az_steps=256, rng=np.random.default_rng(1), noise=0.01)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    est = gt + np.random.default_rng(0).normal(size=gt.shape) * 0.01
    assert ttraj.ate_rmse(gt, est) == jtraj.ate_rmse(gt, est)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_tloam_tpu():
    files = sorted((REPO / "tloam_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tloam_tpu"), f"{path}: imports {mod}"


def test_entry_points_raise_without_gpu_unless_cpu_requested(monkeypatch):
    from tloam_torch.pipeline import frontend as tf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.PipelineConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.run_sequence([], cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCloud.from_numpy(np.zeros((4, 3), np.float32))
    st = tf.init_state(cfg, device="cpu")
    assert st.pose.device == CPU and st.frame_idx == 0


def test_tf32_is_off():
    assert tloam_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_pack_scan_and_from_packed_match(rng):
    xyz = rng.normal(size=(500, 3)) * 20.0
    xyz[3] = [200.0, 0.0, 0.0]  # beyond int16 range: excluded
    inten = rng.uniform(size=500)
    qj, nj = JCloud.pack_scan(xyz, inten, capacity=1024)
    qt, nt = TCloud.pack_scan(xyz, inten, capacity=1024)
    assert nj == nt == 499 and np.array_equal(qj, qt)
    cj = JCloud.from_packed(jnp.asarray(qj), nj)
    ct = TCloud.from_packed(torch.from_numpy(qt), nt)
    np.testing.assert_allclose(np_of(ct.xyz), np.asarray(cj.xyz), atol=1e-6)
    np.testing.assert_allclose(np_of(ct.intensity), np.asarray(cj.intensity), atol=1e-6)
    assert np.array_equal(np_of(ct.valid), np.asarray(cj.valid))
