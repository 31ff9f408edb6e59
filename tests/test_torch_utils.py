"""The port's utils (checkpoint directories, Timer, device_trace) against
tests/test_utils.py's cases for the JAX package's."""

import json

import numpy as np
import pytest
import torch

from audio_inpainting_tpu.utils.checkpoint import latest_checkpoint as jax_latest_checkpoint
from audio_inpainting_torch.utils import (Timer, device_trace, latest_checkpoint,
                                          load_params, save_params)

torch.set_num_threads(1)


def test_checkpoint_roundtrip(tmp_path):
    params = {"dense.kernel": torch.arange(6.0).reshape(2, 3),
              "dense.bias": torch.zeros(3), "scale": torch.tensor(2.5)}
    p = save_params(params, str(tmp_path / "ckpt" / "step_10"))
    back = load_params(p, "cpu")
    assert np.allclose(back["dense.kernel"], np.arange(6.0).reshape(2, 3))
    assert float(back["scale"]) == 2.5
    assert latest_checkpoint(str(tmp_path / "ckpt")) == p
    save_params(params, str(tmp_path / "ckpt" / "step_2"))
    assert latest_checkpoint(str(tmp_path / "ckpt")).endswith("step_10")


@pytest.mark.parametrize("prefix", ["step_", "ckpt-"])
def test_latest_checkpoint_matches_jax(tmp_path, prefix):
    """The same pick as the JAX function from one directory: the largest
    number (not the longest or last name), exact names only, None where
    nothing matches or there is no directory."""
    for name in ("step_2", "step_10", "step_007", "step_x", "step_11.tmp", "xstep_99",
                 "ckpt-3", "ckpt-12", "ckpt-12b"):
        (tmp_path / name).mkdir()
    got = latest_checkpoint(str(tmp_path), prefix)
    assert got == jax_latest_checkpoint(str(tmp_path), prefix)
    assert got == str(tmp_path / ("step_10" if prefix == "step_" else "ckpt-12"))
    assert latest_checkpoint(str(tmp_path), "none_") is None
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert jax_latest_checkpoint(str(tmp_path / "missing")) is None


def test_timer():
    t = Timer()
    x = torch.ones(16) * 2
    lap = t.lap("op", x)
    assert lap >= 0 and t.laps["op"] == lap
    t.lap("nested", {"a": [x, (x,)], "b": None})
    assert set(t.laps) == {"op", "nested"}


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    """A Chrome/Perfetto trace file of the block's operators."""
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir) as d:
        assert d == log_dir
        a = torch.randn(64, 64)
        for _ in range(3):
            a = a @ a
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
