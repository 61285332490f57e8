"""Port: the tiling autotuner (infer/autotune.py), its CLI (cli/tune.py) and
fisr_grid='tuned' (infer/video.resolve_fisr_plan) against
fisr_tpu.infer.autotune and fisr_tpu.infer.video.

The candidate lists are equal to JAX's. 'tuned' resolves to the same plan in
both packages, on an empty cache and on one cache file (on the CPU both key
entries by the device kind 'cpu'). Sweeps run FISRnet at ch=8 on the CPU at
96x96 (host-clock timings: their order is checked, never their values).
"""

import json
import os

import pytest
import torch

from fisr_tpu.infer import autotune as jautotune
from fisr_tpu.infer import video as jvideo
from fisr_tpu.ops.conv import F32 as JF32
from fisr_tpu.ops.conv import Policy as JPolicy
from fisr_tpu_torch.infer import autotune, video
from fisr_tpu_torch.infer.autotune import TuneCache, candidate_grids, padded_candidates, sweep
from fisr_tpu_torch.infer.device import padded_grid
from fisr_tpu_torch.models.fisrnet import FISRnet
from fisr_tpu_torch.ops.conv import BF16, F32

torch.set_num_threads(1)
SIZES = [(32, 32), (64, 64), (96, 96), (256, 448), (544, 960), (736, 1280), (1024, 1920),
         (1056, 1920), (1088, 1920), (2144, 3840), (2176, 4096)]


@pytest.fixture(scope="module")
def model():
    return FISRnet(ch=8, device="cpu")


@pytest.fixture
def cache_path(tmp_path, monkeypatch):
    """Both packages' default cache pointed at one empty file path."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", path)
    monkeypatch.setattr(jautotune, "DEFAULT_CACHE_PATH", path)
    return path


@pytest.mark.parametrize("hw", SIZES)
def test_candidates_match_jax(hw):
    h, w = hw
    assert candidate_grids(h, w) == jautotune.candidate_grids(h, w)
    assert candidate_grids(h, w, 3, 4) == jautotune.candidate_grids(h, w, 3, 4)
    assert padded_candidates(h, w) == jautotune.padded_candidates(h, w)
    assert padded_candidates(h, w, 4, 6, 0.1) == jautotune.padded_candidates(h, w, 4, 6, 0.1)


def test_candidate_grids_respect_32_multiples():
    assert candidate_grids(96, 96) == [(1, 1), (1, 3), (3, 1), (3, 3)]
    got = candidate_grids(1024, 1920)
    assert (4, 6) in got and (1, 1) in got
    assert all(1024 % (32 * gh) == 0 and 1920 % (32 * gw) == 0 for gh, gw in got)
    # 18 pad-free and 30 padded plans at the serving size
    assert len(got) == 18 and len(padded_candidates(1024, 1920)) == 30
    for fn in (candidate_grids, padded_candidates):
        with pytest.raises(ValueError):
            fn(100, 96)


def test_dtype_names_and_device_kind_match_jax():
    assert autotune.dtype_name(F32) == "float32" and autotune.dtype_name(BF16) == "bfloat16"
    assert TuneCache._device_kind("cpu") == jautotune.TuneCache._device_kind() == "cpu"


def test_sweep_orders_results_and_tags_modes(model):
    res = sweep(model, 96, 96, policy=F32, reps=1, grids=[(1, 1), (3, 3)], device="cpu")
    assert [r["mode"] for r in sorted(res, key=lambda r: r["grid"])] == ["full", "tiled"]
    assert res == sorted(res, key=lambda r: r["sec"])
    assert all(r["pad"] == [0, 0] and r["sec"] > 0 for r in res)
    # without `grids`: the pad-free and padded candidates up to (max_gh, max_gw)
    # (256 columns reach 3 patches with a 32-px pad)
    plans = sweep(model, 32, 256, policy=F32, reps=1, device="cpu", max_gh=1, max_gw=3)
    assert {(tuple(r["grid"]), tuple(r["pad"]), r["mode"]) for r in plans} == {
        ((1, 1), (0, 0), "full"), ((1, 2), (0, 0), "tiled"), ((1, 3), (0, 32), "padded")}


def test_sweep_lets_errors_other_than_memory_propagate(model):
    """The JAX sweep skips a candidate on any error; the port skips only an
    out-of-memory one, so a broken plan surfaces."""
    with pytest.raises(ValueError, match="does not divide"):
        sweep(model, 96, 96, policy=F32, reps=1, grids=[(5, 1)], device="cpu")


def test_tune_cache_roundtrip(tmp_path, model):
    path = str(tmp_path / "autotune.json")
    cache = TuneCache(path, device="cpu")
    grid = cache.tune(model, 96, 96, policy=F32, reps=1)
    assert 96 % (32 * grid[0]) == 0 and 96 % (32 * grid[1]) == 0
    fresh = TuneCache(path, device="cpu")
    assert fresh.best_plan(96, 96, "float32") == (grid, (0, 0))
    assert fresh.best_plan(128, 128, "float32") is None
    assert fresh.best_plan(96, 96, "bfloat16") is None
    (key,) = json.loads(open(path).read())
    assert key == "cpu|96x96|float32|b32"


def test_shipped_cache_fallback_and_local_wins(tmp_path):
    """Plans under `shipped_path` serve where the user cache has no entry; a
    local tune for the same key wins. The port ships no plans."""
    key = "cpu|1056x1920|bfloat16|b32"
    shipped = str(tmp_path / "shipped.json")
    local = str(tmp_path / "autotune.json")
    with open(shipped, "w") as f:
        json.dump({key: {"results": [
            {"grid": [4, 6], "pad": [96, 0], "sec": 0.21, "mode": "padded"},
            {"grid": [3, 6], "pad": [0, 0], "sec": 0.23, "mode": "tiled"},
        ], "reps": 3}}, f)
    cache = TuneCache(local, shipped_path=shipped, device="cpu")
    assert cache.best_plan(1056, 1920) == ((4, 6), (96, 0))
    with open(local, "w") as f:
        json.dump({key: {"results": [
            {"grid": [2, 4], "pad": [0, 0], "sec": 0.19, "mode": "tiled"},
        ], "reps": 3}}, f)
    cache = TuneCache(local, shipped_path=shipped, device="cpu")
    assert cache.best_plan(1056, 1920) == ((2, 4), (0, 0))
    cache = TuneCache(local, shipped_path=str(tmp_path / "missing.json"), device="cpu")
    assert cache.best_plan(1056, 1920) == ((2, 4), (0, 0))
    assert not os.path.exists(autotune.SHIPPED_CACHE_PATH)


def _resolved(h, w):
    return [video.resolve_fisr_plan(spec, h, w, pol, device="cpu")
            for spec in ("tuned", "auto", (2, 3)) for pol in (F32, BF16)]


def _jresolved(h, w):
    import jax.numpy as jnp

    return [jvideo.resolve_fisr_plan(spec, h, w, pol)
            for spec in ("tuned", "auto", (2, 3)) for pol in (JF32, JPolicy(jnp.bfloat16))]


@pytest.mark.parametrize("hw", [(96, 96), (1056, 1920)])
def test_tuned_falls_back_like_jax_on_an_empty_cache(cache_path, hw):
    """(e) 'tuned' with nothing tuned: both packages give the heuristic."""
    h, w = hw
    assert _resolved(h, w) == _jresolved(h, w)
    assert video.resolve_fisr_plan("tuned", h, w, F32, device="cpu") == padded_grid(h, w)


def test_tuned_reads_one_cache_file_like_jax(cache_path, model):
    """(e) One cache file, written by the port's tune and extended by hand
    with a padded winner: both packages resolve every spec alike."""
    grid = TuneCache(device="cpu").tune(model, 96, 96, policy=F32, reps=1)
    with open(cache_path) as f:
        data = json.load(f)
    data["cpu|1056x1920|float32|b32"] = {"results": [
        {"grid": [4, 6], "pad": [96, 0], "sec": 0.21, "mode": "padded"},
        {"grid": [1, 2], "pad": [0, 0], "sec": 0.23, "mode": "tiled"}], "reps": 3}
    with open(cache_path, "w") as f:
        json.dump(data, f)
    assert video.resolve_fisr_plan("tuned", 96, 96, F32, device="cpu") == (grid, (0, 0))
    assert video.resolve_fisr_plan("tuned", 1056, 1920, F32, device="cpu") == ((4, 6), (96, 0))
    for hw in ((96, 96), (1056, 1920)):
        assert _resolved(*hw) == _jresolved(*hw)


def test_tune_cli_prints_the_jax_keys(tmp_path, capsys):
    from fisr_tpu_torch.cli import tune as tune_cli

    path = str(tmp_path / "cache.json")
    rec = tune_cli.main(["--height", "64", "--width", "64", "--dtype", "float32", "--reps", "1",
                         "--cache", path, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == rec
    assert set(rec) == {"best_grid", "best_plan", "frame", "dtype", "device_kind", "cache"}
    assert rec["frame"] == [64, 64] and rec["cache"] == path and rec["device_kind"] == "cpu"
    gh, gw = rec["best_grid"]
    assert 64 % (32 * gh) == 0 and 64 % (32 * gw) == 0
    assert rec["best_plan"] == {"grid": rec["best_grid"], "pad": [0, 0]}
    assert json.load(open(path))


def test_tune_parser_carries_the_jax_flags():
    from fisr_tpu.cli import tune as jtune
    from fisr_tpu_torch.cli import tune as tune_cli

    ours = {a.dest: a.default for a in tune_cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in jtune.build_parser()._actions}
    assert {k: ours.get(k, "missing") for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"device"}


def test_tuned_needs_a_card_when_it_names_one(cache_path, monkeypatch):
    """The cache key names the device kind, so 'tuned' on "cuda" without a
    card raises rather than reading the CPU's entries."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        video.resolve_fisr_plan("tuned", 96, 96, F32)


@pytest.mark.cuda
def test_memory_check_and_sweep_on_the_card(model):
    """On the card: the memory check measures a tiny window's need under the
    card's total, and a two-grid sweep times both with CUDA events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fisr_tpu_torch.utils.profiling import assert_fits_hbm

    dev = torch.device("cuda")
    m = FISRnet(ch=8, device=dev)
    x = torch.rand((1, 64, 64, 29), device=dev)
    with torch.no_grad():
        info = assert_fits_hbm(lambda t: m(t), (x,), what="tiny window")
    assert 0 < info["need_bytes"] <= info["budget_bytes"] < info["limit_bytes"]
    with pytest.raises(RuntimeError, match="fisr_tpu_torch.cli.tune"):
        with torch.no_grad():
            assert_fits_hbm(lambda t: m(t), (x,), what="tiny window", limit_bytes=1024)
    res = sweep(m, 64, 64, policy=F32, reps=2, grids=[(1, 1), (2, 2)], device=dev)
    assert sorted(tuple(r["grid"]) for r in res) == [(1, 1), (2, 2)]
    assert all(r["sec"] > 0 for r in res)
