"""Whole runs of each cell's driver at tiny shapes on the CPU (the look for a
card skipped): a sound run comes out correct, and a run whose timed path is
broken underneath comes out not correct, under the cell's own limits."""

from __future__ import annotations

import pytest

from fisrbench.harness.manifest import Manifest
from fisrbench.tests.tiny import cells_of, tiny_ctx


def _run(ctx):
    return Manifest.driver(ctx.mix).run(ctx)


@pytest.mark.parametrize("cell", cells_of("video"))
def test_video_sound_run_is_correct(cell):
    out = _run(tiny_ctx(cell))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.e2e["video_fps"] > 0


@pytest.mark.parametrize("cell", cells_of("video"))
def test_video_altered_answer_fails(cell, monkeypatch):
    import fisr_tpu_torch.infer.video as video

    real = video.make_fisr_window_fn

    def altered(*a, **k):
        fn = real(*a, **k)
        return lambda *x: (fn(*x) * 0.8).clamp(0.0, 1.0)

    monkeypatch.setattr(video, "make_fisr_window_fn", altered)
    out = _run(tiny_ctx(cell))
    assert not out.correct, out.checks


@pytest.mark.parametrize("cell", cells_of("train_pwc"))
def test_train_sound_run_is_correct(cell):
    out = _run(tiny_ctx(cell))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.e2e["train_sps"] > 0


@pytest.mark.parametrize("cell", cells_of("train_pwc"))
def test_train_unchanged_state_fails(cell, monkeypatch):
    from fisr_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.TFAdam, "step", lambda self, closure=None: None)
    out = _run(tiny_ctx(cell))
    assert not out.correct, out.checks
    assert dict((n, v) for n, v, _ in out.checks)["change_norm_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", cells_of("train_pwc"))
def test_train_half_batch_fails(cell, monkeypatch):
    from fisr_tpu_torch.train import pwc_trainer

    real = pwc_trainer.make_pwc_train_step

    def half(*a, **k):
        step = real(*a, **k)

        def fn(state, batch):
            n = len(batch["x"]) // 2
            return step(state, {key: v[:n] for key, v in batch.items()})
        return fn

    monkeypatch.setattr(pwc_trainer, "make_pwc_train_step", half)
    out = _run(tiny_ctx(cell))
    assert not out.correct, out.checks


@pytest.mark.parametrize("cell", cells_of("serve"))
def test_serve_sound_run_is_correct(cell):
    out = _run(tiny_ctx(cell, seconds=1.0))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.e2e["serve_wps"] > 0


@pytest.mark.parametrize("cell", cells_of("serve"))
def test_serve_altered_answer_fails(cell, monkeypatch):
    import fisr_tpu_torch.infer.daemon as daemon

    real = daemon.make_fused_video_step

    def altered(*a, **k):
        fn = real(*a, **k)
        return lambda *x: (fn(*x) * 0.8).clamp(0.0, 1.0)

    monkeypatch.setattr(daemon, "make_fused_video_step", altered)
    out = _run(tiny_ctx(cell, seconds=1.0))
    assert not out.correct, out.checks
