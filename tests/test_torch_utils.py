"""The port's debug, profiling and logging utilities (``utils/debug.py``,
``utils/profiling.py``, ``utils/logging.py``) against the JAX package's, on
the CPU: ``nan_checked`` raising on NaN and Inf in an output, naming the
leaf; ``StepTimer``'s skip-first mean; a Chrome trace naming an
``annotate`` region; the JSON-lines records equal to JAX's except the
time ``t``; the TensorBoard sink's scalars."""

import json
import time

import numpy as np
import pytest
import torch

from clip_codec_tpu.utils import profiling as jprof
from clip_codec_tpu.utils.logging import TrainLogger as JaxTrainLogger
from clip_codec_tpu_torch.utils import debug, profiling
from clip_codec_tpu_torch.utils.logging import TrainLogger


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")], ids=["nan", "inf", "-inf"])
def test_nan_checked_raises_naming_the_leaf(bad):
    def step(x):
        return {"loss": x.sum(), "aux": [x.long(), x * bad]}

    checked = debug.nan_checked(step)
    with pytest.raises(FloatingPointError, match=r"step output\['aux'\]\[1\]"):
        checked(torch.ones(3))
    out = debug.nan_checked(lambda x: (x, x.long()))(torch.ones(2))
    assert torch.equal(out[0], torch.ones(2))
    assert checked.__name__ == "step"


def test_assert_finite_tree_on_state_dicts_and_arrays():
    debug.assert_finite_tree({"w": torch.zeros(2), "n": np.ones(3), "i": torch.arange(3), "s": 1.0})
    with pytest.raises(FloatingPointError, match=r"params\['b'\]\[0\]"):
        debug.assert_finite_tree({"a": np.ones(2), "b": [np.array([np.nan])]}, "params")
    with pytest.raises(FloatingPointError, match=r"tree\['x'\]"):
        debug.assert_finite_tree({"x": float("inf")})


def _times(timer_cls, sleeps):
    t = timer_cls(skip_first=1)
    for s in sleeps:
        with t:
            time.sleep(s)
    return t


def test_step_timer_skips_the_first_step_as_jax():
    sleeps = [0.2, 0.01, 0.03]
    mine, ref = _times(profiling.StepTimer, sleeps), _times(jprof.StepTimer, sleeps)
    assert mine._seen == ref._seen == 3
    assert 0.015 <= mine.mean_s < 0.1 and abs(mine.mean_s - ref.mean_s) < 0.02
    assert profiling.StepTimer().mean_s == jprof.StepTimer().mean_s == 0.0


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    with profiling.trace(tmp_path / "tr") as prof:
        with profiling.annotate("decode_region"):
            torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8), torch.ones(4, 3, 3, 3))
    data = json.loads((tmp_path / "tr" / profiling.TRACE_NAME).read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "decode_region" in names and any("conv" in str(n) for n in names)
    assert any(e.key == "decode_region" for e in prof.key_averages())


def _records(path):
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    for r in recs:
        r.pop("t", None)
    return recs


def test_jsonl_records_equal_jax(tmp_path, capsys):
    for cls, name in ((JaxTrainLogger, "jax"), (TrainLogger, "port")):
        log = cls(log_every=2, jsonl_path=str(tmp_path / f"{name}.jsonl"))
        for s in range(5):
            log.step(s, 1.0 / (s + 1))
        log.epoch(1, 2, 0.25, 12.5)
    assert _records(tmp_path / "port.jsonl") == _records(tmp_path / "jax.jsonl")
    assert len(_records(tmp_path / "port.jsonl")) == 4
    out = capsys.readouterr().out.splitlines()
    assert out[: len(out) // 2] == out[len(out) // 2:]  # the same stdout lines
    quiet = TrainLogger(log_every=1, enabled=False, jsonl_path=tmp_path / "quiet.jsonl")
    quiet.step(0, 1.0)
    quiet.epoch(1, 1, 1.0, 1.0)
    assert not (tmp_path / "quiet.jsonl").exists() and capsys.readouterr().out == ""


def test_tensorboard_sink(tmp_path, monkeypatch, capsys):
    pytest.importorskip("tensorboard")
    log = TrainLogger(tensorboard_dir=tmp_path / "tb")
    log.step(0, 0.5)
    log.epoch(1, 1, 0.5, 1.0)
    log.close()
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    import builtins

    real = builtins.__import__

    def no_tb(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    log = TrainLogger(tensorboard_dir=tmp_path / "tb2")
    log.step(0, 0.5)
    assert "TensorBoard sink off" in capsys.readouterr().err
    assert not (tmp_path / "tb2").exists()
