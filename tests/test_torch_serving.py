"""Port: multi-device inference (infer/sharded.py, infer/serving.py) on 2 CPU
ranks over gloo, against the single-process port and the JAX package's
functions on 2 of its 8 virtual CPU devices.

The ranks run as in tests/test_torch_distributed.py (`run_ranks`); each
writes its block of every output and the tests gather them. FISRnet ch=8
and PWC-Net pyr_lvls=4 / flow_pred_lvl=2 / search range 2 on the oracle
generator's damped weights (carried into the JAX trees with
convert/params), f32, 32x32 frames (32x128 for the sharded runner: 64
columns a rank, so the halo (32) is inside the neighbour's strip).
Tolerances, with what was measured here:
* against the single-process port (the (1, 2) padded tiling, the device
  runners, the fused step, the pair-cached loop): atol 1e-5 (measured
  1.5e-8 for the sharded runner and 1.0e-8 for a ragged round, 0 for the
  rest);
* against the JAX functions: atol 1e-4, the port's usual f32 bound
  (tests/test_torch_video.py; measured 5.2e-8 on predictions and flows,
  3.1e-5 on the carried warps, one f32 ulp of values up to 255);
* the stream step's carry: the same on both ranks (equal), and within 1e-5
  of `make_pair_fn` on that pair (measured 0).
"""

import os

import numpy as np
import pytest
import torch

from fisr_tpu_torch.convert import params
from fisr_tpu_torch.core import mesh
from fisr_tpu_torch.infer import serving, sharded, video
from fisr_tpu_torch.infer.device import make_device_runner
from fisr_tpu_torch.infer.tiled import TiledRunner
from fisr_tpu_torch.models import pwcnet
from test_torch_distributed import WORLD, _load, run_ranks

torch.set_num_threads(1)
SMALL = dict(pyr_lvls=4, flow_pred_lvl=2, search_range=2)
CFG = pwcnet.PWCNetConfig(**SMALL)
PORT_TOL, JAX_TOL = 1e-5, 1e-4


def _models():
    return (params.deterministic_fisrnet(ch=8, device="cpu"),
            params.deterministic_pwcnet(CFG, device="cpu"))


def _inputs():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    seq = np.stack([np.stack([127.5 + 120 * np.sin(0.15 * (xx - 2 * t) + 0.1 * (yy - t) + c)
                              for c in range(3)], -1) for t in range(10)]).astype(np.float32)
    return {"strip": rng.uniform(size=(1, 32, 128, 29)).astype(np.float32),
            "windows": rng.uniform(size=(4, 32, 64, 29)).astype(np.float32),
            "frames": rng.uniform(0, 255, size=(4, 3, 32, 32, 3)).astype(np.float32),
            "seq": seq,
            "stream": np.stack([seq[k:k + 3] for k in range(8)])}


def _serving(rank, out):
    fisr, pwc = _models()
    x = _inputs()
    m = mesh.make_mesh((WORLD, 1), device="cpu")
    ms = mesh.make_mesh((1, WORLD), device="cpu")
    runner = sharded.make_sharded_runner(ms, boundary=32)
    res = {"sharded": runner(fisr, x["strip"])}
    try:
        runner(fisr, x["strip"][:, :, :96])
    except ValueError as e:
        res["sharded_error"] = str(e)
    for mode, grid in (("full", (1, 1)), ("tiled", (1, 2))):
        run = serving.make_frame_parallel_runner(m, mode=mode, grid=grid)
        res[f"runner_{mode}"] = run(fisr, x["windows"])
    res["video"] = serving.make_frame_parallel_video_step(m, cfg=CFG)(fisr, pwc, x["frames"])
    seq = torch.from_numpy(x["seq"])
    carry0 = video.make_pair_fn(CFG)(pwc, seq[None, 0], seq[None, 1])
    step = serving.make_frame_parallel_stream_step(m, cfg=CFG)
    carry, preds = carry0, []
    for r in range(2):
        pred, carry = step(fisr, pwc, x["stream"][4 * r:4 * r + 4], carry)
        preds.append(pred)
    res["stream"], res["stream_carry"] = preds, carry
    ragged = serving.make_frame_parallel_stream_step(m, cfg=CFG, ragged=True)
    for n_valid in (1, 3):
        padded, n = serving.pad_stream_round(x["stream"][:n_valid], 4)
        res[f"ragged_{n_valid}"] = ragged(fisr, pwc, padded, carry0, n)
    torch.save(res, os.path.join(out, f"serving_{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serving"))
    run_ranks(_serving, out, out)
    return [_load(os.path.join(out, f"serving_{r}.pt")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    from fisr_tpu.core import mesh as jmesh
    from fisr_tpu.models import pwcnet as jpwcnet

    fisr, pwc = _models()
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return (as_jax(params.to_jax_tree(fisr)), as_jax(params.to_jax_tree(pwc)),
            jpwcnet.PWCNetConfig(**SMALL, cost_volume_impl="xla"),
            jmesh.make_mesh((WORLD, 1), devices=jax.devices()[:WORLD]),
            jmesh.make_mesh((1, WORLD), devices=jax.devices()[:WORLD]))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _rows(ranks, key):
    return torch.cat([r[key] for r in ranks]).numpy()


def test_sharded_runner_matches_padded_tiling_and_jax(ranks, jax_side):
    """The halo exchange equals the zero-padded tiling with a (1, 2) grid
    (tests/test_infer.py::test_sharded_matches_padded_tiling)."""
    from fisr_tpu.infer.sharded import make_sharded_runner

    x = _inputs()["strip"]
    got = torch.cat([r["sharded"] for r in ranks], dim=2).numpy()
    assert got.shape == (1, 64, 256, 9)
    fisr, _ = _models()
    _close(got, TiledRunner(fisr, grid=(1, WORLD), boundary=32, mode="padded", device="cpu")(x),
           PORT_TOL)
    jfisr, _, _, _, jm_sp = jax_side
    _close(got, make_sharded_runner(jm_sp, boundary=32)(jfisr, x), JAX_TOL)
    assert all(r["sharded_error"] == "width 96 must divide by 2 strips x 32" for r in ranks)


@pytest.mark.parametrize("mode", ["full", "tiled"])
def test_frame_parallel_runner_matches_device_runner_and_jax(ranks, jax_side, mode):
    from fisr_tpu.infer.serving import make_frame_parallel_runner

    grid = (1, 1) if mode == "full" else (1, 2)
    windows = _inputs()["windows"]
    got = _rows(ranks, f"runner_{mode}")
    fisr, _ = _models()
    _close(got, make_device_runner(mode, grid=grid)(fisr, torch.from_numpy(windows)), PORT_TOL)
    jfisr, _, _, jm, _ = jax_side
    _close(got, make_frame_parallel_runner(jm, mode=mode, grid=grid)(jfisr, windows), JAX_TOL)


def test_frame_parallel_video_step_matches_fused_step_and_jax(ranks, jax_side):
    from fisr_tpu.infer.serving import make_frame_parallel_video_step

    frames = _inputs()["frames"]
    got = _rows(ranks, "video")
    assert got.shape == (4, 64, 64, 9)
    fisr, pwc = _models()
    _close(got, video.make_fused_video_step(CFG)(fisr, pwc, torch.from_numpy(frames)), PORT_TOL)
    jfisr, jpwc, jcfg, jm, _ = jax_side
    _close(got, make_frame_parallel_video_step(jm, cfg=jcfg)(jfisr, jpwc, frames), JAX_TOL)


def _monolithic(windows):
    fisr, pwc = _models()
    return video.make_fused_video_step(CFG)(fisr, pwc, torch.from_numpy(windows)).numpy()


def _pair(seq, k):
    _, pwc = _models()
    seq = torch.from_numpy(seq)
    return video.make_pair_fn(CFG)(pwc, seq[None, k], seq[None, k + 1])


def _same_carry(c0, c1, want):
    for a, b, w in zip(c0, c1, want, strict=True):
        assert torch.equal(a, b)
        _close(a, w, PORT_TOL)


def test_stream_step_matches_the_monolithic_loop_and_jax(ranks, jax_side):
    """Two rounds of 4 consecutive windows (2 a rank): the shared pair
    crosses ranks once a round; the carry after round 2 is pair (8, 9) on
    both ranks."""
    from fisr_tpu.infer.serving import make_frame_parallel_stream_step
    from fisr_tpu.infer.video import make_pair_fn

    x = _inputs()
    got = np.concatenate([torch.cat([r["stream"][k] for r in ranks]).numpy() for k in range(2)])
    assert got.shape == (8, 64, 64, 9)
    _close(got, _monolithic(x["stream"]), PORT_TOL)
    _same_carry(ranks[0]["stream_carry"], ranks[1]["stream_carry"], _pair(x["seq"], 8))

    jfisr, jpwc, jcfg, jm, _ = jax_side
    step = make_frame_parallel_stream_step(jm, cfg=jcfg)
    carry = make_pair_fn(jcfg)(jpwc, x["seq"][None, 0], x["seq"][None, 1])
    want = []
    for r in range(2):
        pred, carry = step(jfisr, jpwc, x["stream"][4 * r:4 * r + 4], carry)
        want.append(np.asarray(pred))
    _close(got, np.concatenate(want), JAX_TOL)
    for a, b in zip(ranks[0]["stream_carry"], carry):
        _close(a, b, JAX_TOL)


@pytest.mark.parametrize("n_valid", [1, 3])
def test_ragged_stream_round_matches_the_monolithic_loop_and_jax(ranks, jax_side, n_valid):
    """A final short round padded to 4: the valid windows equal the loop's,
    and the carry is window n_valid - 1's new pair (on rank 0 for 1, on
    rank 1 for 3), on both ranks."""
    from fisr_tpu.infer.serving import make_frame_parallel_stream_step, pad_stream_round
    from fisr_tpu.infer.video import make_pair_fn

    x = _inputs()
    pred = torch.cat([r[f"ragged_{n_valid}"][0] for r in ranks]).numpy()
    assert pred.shape == (4, 64, 64, 9)
    _close(pred[:n_valid], _monolithic(x["stream"][:n_valid]), PORT_TOL)
    _same_carry(ranks[0][f"ragged_{n_valid}"][1], ranks[1][f"ragged_{n_valid}"][1],
                _pair(x["seq"], n_valid))

    import jax.numpy as jnp

    jfisr, jpwc, jcfg, jm, _ = jax_side
    step = make_frame_parallel_stream_step(jm, cfg=jcfg, ragged=True)
    carry0 = make_pair_fn(jcfg)(jpwc, x["seq"][None, 0], x["seq"][None, 1])
    padded, n = pad_stream_round(x["stream"][:n_valid], 4)
    want, carry = step(jfisr, jpwc, padded, carry0, jnp.asarray(n))
    _close(pred[:n_valid], np.asarray(want)[:n_valid], JAX_TOL)
    for a, b in zip(ranks[0][f"ragged_{n_valid}"][1], carry):
        _close(a, b, JAX_TOL)


def test_pad_stream_round_matches_jax():
    from fisr_tpu.infer import serving as jserving

    w = np.random.default_rng(3).uniform(size=(3, 3, 4, 4, 3)).astype(np.float32)
    for n_round in (3, 5):
        got, n = serving.pad_stream_round(w, n_round)
        want, jn = jserving.pad_stream_round(w, n_round)
        assert n == jn == 3 and isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t = torch.from_numpy(w)
    assert serving.pad_stream_round(t, 3)[0] is t
    for bad, n_round in ((w, 2), (w[:0], 4)):
        with pytest.raises(ValueError) as ours:
            serving.pad_stream_round(bad, n_round)
        with pytest.raises(ValueError) as theirs:
            jserving.pad_stream_round(bad, n_round)
        assert str(ours.value) == str(theirs.value)
