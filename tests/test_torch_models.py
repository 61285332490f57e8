"""Port: FISRnet and PWC-Net against the reference's TF graphs (the TF-oracle
fixtures, same bounds as tests/test_tf_oracle.py) and against the JAX
package's models on the same weights.

Measured max |diff| (f32, CPU): forward.npz 4.1e-8 (bound 5e-7);
pwc_forward.npz 2.7e-8 per level (bound 2e-7), 8.8e-8 on flow_pred (bound
5e-7); FISRnet ch=8 vs fisrnet.apply 3.0e-8, PWC-Net (4 levels, d=2, plain
glorot weights, flows up to 1.7) vs pwcnet.apply 6.0e-6 (bound 1e-4, the
whole-model bound). The tiling options of FISRnet (ch=8) against JAX
(bound 1e-4): apply_level with stale_halo 9.3e-9, fast_upsample 1.1e-8;
JAX's input glue (extra, in_stride) against the port's level on the
composed input 3.5e-8 and 1.0e-8, with fast_upsample 2.5e-8; each option of
`apply`, JAX's fuse_input_glue against the port's one input path, at most
3.7e-8 a level. The stale-halo shrink against the full ring on the retained
pixels: 0, equal bit for bit on the CPU at ch=8 and at ch=64 (the conv
library ran one algorithm for both extents); the test allows 1e-6 where it
does not. The JAX package's halo-tiled PWC-Net stages against the port's
whole ones: see test_untiled_pwcnet_against_jax_tiled_at_video_extents.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.models import fisrnet as jfisrnet
from fisr_tpu.models import pwcnet as jpwcnet
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.oracle import deterministic_tf_vars, tf_vars_digest
from fisr_tpu_torch.models import fisrnet, pwcnet
from fisr_tpu_torch.ops.resize import downsample_int

torch.set_num_threads(1)
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "tf_oracle")
SMALL = dict(pyr_lvls=4, flow_pred_lvl=2, search_range=2)


def _manifest(name):
    with open(os.path.join(FIX, name)) as f:
        return json.load(f)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_fisrnet_matches_reference_tf_graph():
    shapes = params._tf_shapes(fisrnet.FISRnet(device="cpu"), params.fisrnet_name_map())
    tf_vars = deterministic_tf_vars(shapes)
    assert tf_vars_digest(tf_vars) == _manifest("manifest.json")["weights_digest"]
    model = params.from_tf_vars(tf_vars, "fisrnet", device="cpu")
    assert fisrnet.param_count(model) == 48_316_251
    z = np.load(os.path.join(FIX, "forward.npz"))
    with torch.no_grad():
        preds = fisrnet.apply(model, torch.from_numpy(z["input"]))
    for lvl, got in enumerate(preds, 1):
        np.testing.assert_allclose(got.numpy(), z[f"pred_l{lvl}"], rtol=0, atol=5e-7,
                                   err_msg=f"pred_l{lvl} vs TF graph")


def test_pwcnet_matches_reference_tf_graph():
    cfg = pwcnet.PWCNetConfig(cost_volume_impl="plain")
    model = params.deterministic_pwcnet(cfg, device="cpu")
    shapes = params._tf_shapes(model, params.pwcnet_name_map())
    assert tf_vars_digest(deterministic_tf_vars(shapes)) == \
        _manifest("pwc_manifest.json")["weights_digest"]
    z = np.load(os.path.join(FIX, "pwc_forward.npz"))
    x = torch.from_numpy(z["input"])
    with torch.no_grad():
        pred, pyr = pwcnet.apply(model, x[:, 0], x[:, 1], cfg)
    for lvl, flow in zip(range(6, 1, -1), pyr):
        np.testing.assert_allclose(flow.numpy(), z[f"pyr_lvl{lvl}"], rtol=0, atol=2e-7,
                                   err_msg=f"pyramid level {lvl}")
    np.testing.assert_allclose(pred.numpy(), z["flow_pred"], rtol=0, atol=5e-7)


def _small_fisr_tree():
    """ch=8 FISRnet tree on the oracle generator's damped weights (plain
    glorot weights blow level 3 up to O(10), where f32 noise alone passes
    1e-4); converted by the JAX package's own name map."""
    from fisr_tpu.convert.tf_import import convert_fisrnet, export_fisrnet

    shapes = {n: a.shape for n, a in export_fisrnet(
        jfisrnet.init_params(jax.random.PRNGKey(0), ch=8)).items()}
    return convert_fisrnet(deterministic_tf_vars(shapes))


def test_fisrnet_matches_jax_apply():
    tree = _small_fisr_tree()
    model = params.fisrnet_from_jax(tree, device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, size=(1, 32, 64, 29)).astype(np.float32)
    want = jfisrnet.apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(stale_halo=32), dict(fast_upsample=True), dict(stale_halo=16, fast_upsample=True),
    dict(extra=True), dict(in_stride=2), dict(extra=True, in_stride=4, fast_upsample=True),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_apply_level_options_match_jax(kw):
    """The JAX package's input glue (`extra`, `in_stride`: a TPU rewrite)
    is held against the port's level on the composed input
    cat([downsample_int(x, in_stride), extra])."""
    tree = _small_fisr_tree()
    model = params.fisrnet_from_jax(tree, device="cpu")
    kw = dict(kw)
    stride = kw.pop("in_stride", 1)
    jkw = {"in_stride": stride} if stride != 1 else {}
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, size=(1, 96, 128, 29)).astype(np.float32)
    tx = downsample_int(torch.from_numpy(x), stride)
    if kw.pop("extra", False):
        extra = rng.uniform(0, 1, size=(1, 96 // stride, 128 // stride, 9)).astype(np.float32)
        lvl, jkw["extra"] = "level_3", jnp.asarray(extra)
        tx = torch.cat([tx, torch.from_numpy(extra)], -1)
    else:
        lvl = "level_1"
    want = jfisrnet.apply_level(tree[lvl], jnp.asarray(x), **kw, **jkw)
    with torch.no_grad():
        got = fisrnet.apply_level(getattr(model, lvl), tx, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(final_stale_halo=32), dict(fast_upsample=True), dict(fuse_input_glue=True),
    dict(final_stale_halo=32, fast_upsample=True, fuse_input_glue=True),
], ids=lambda kw: "-".join(kw))
def test_apply_options_match_jax(kw):
    """fuse_input_glue goes to the JAX package alone: the port has one input
    path, the composition, which the glue rewrites for the TPU."""
    tree = _small_fisr_tree()
    model = params.fisrnet_from_jax(tree, device="cpu")
    x = np.random.default_rng(3).uniform(0, 1, size=(1, 96, 128, 29)).astype(np.float32)
    want = jfisrnet.apply(tree, jnp.asarray(x), **kw)
    with torch.no_grad():
        got = fisrnet.apply(model, torch.from_numpy(x),
                            **{k: v for k, v in kw.items() if k != "fuse_input_glue"})
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    ring = 2 * (fisrnet._TAIL_HEADS if "final_stale_halo" in kw else 0)
    assert got[2].shape == (1, 192 - 2 * (64 - ring) if ring else 192,
                            256 - 2 * (64 - ring) if ring else 256, 9)


def test_stale_halo_shrink_equals_full_ring_on_retained_pixels():
    """The cells the shrink removes reach only cells that are removed: the
    retained output is the full ring's, bit for bit where the conv library
    runs one algorithm for both extents, within 1e-6 (f32) where not."""
    tree = _small_fisr_tree()
    model = params.fisrnet_from_jax(tree, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, size=(1, 160, 160, 29))
                         .astype(np.float32))
    with torch.no_grad():
        full = fisrnet.apply(model, x)[2]
        shrunk = fisrnet.apply(model, x, final_stale_halo=32)[2]
        fast_full = fisrnet.apply(model, x, fast_upsample=True)[2]
        fast_shrunk = fisrnet.apply(model, x, final_stale_halo=32, fast_upsample=True)[2]
    assert shrunk.shape == (1, 224, 224, 9)
    for a, b in ((shrunk, full), (fast_shrunk, fast_full)):
        diff = (a[:, 16:-16, 16:-16] - b[:, 64:-64, 64:-64]).abs().max().item()
        assert diff <= 1e-6, diff
    with pytest.raises(ValueError, match="stale_halo"):
        fisrnet.apply(model, x, final_stale_halo=20)


def test_pwcnet_matches_jax_apply():
    jcfg = jpwcnet.PWCNetConfig(**SMALL, cost_volume_impl="xla")
    tree = jpwcnet.init_params(jax.random.PRNGKey(1), jcfg)
    cfg = pwcnet.PWCNetConfig(**SMALL)
    model = params.pwcnet_from_jax(_np_tree(tree), cfg, device="cpu")
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(0, 1, size=(2, 32, 48, 3)).astype(np.float32) for _ in range(2))
    want, want_pyr = jpwcnet.apply(tree, jnp.asarray(a), jnp.asarray(b), jcfg)
    with torch.no_grad():
        got, got_pyr = model(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got_pyr, want_pyr):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_untiled_pwcnet_against_jax_tiled_at_video_extents(monkeypatch):
    """At video extents the JAX package runs PWC-Net's level-1 feature block
    (`_feature_grid`) and its flow-level estimator (`_estimator_grid`) patch
    by patch through halo_map, a TPU layout choice; the port runs both
    whole, the function the benchmark's reference computes (a deliberate
    difference, ROADMAP Queue 3). Here the JAX package's grids are replaced
    by (2, 2) at the same two stages of a small shape. Each tiled stage
    equals the port's in its patch interiors and differs only in a band at
    the frame edge, where it reads a zero ring in place of its own SAME
    padding. Through the whole network the band reaches the coarse levels,
    whose estimators and context networks cover all of their small extent,
    so the flows differ everywhere, most at the edge; that is bounded
    (measured: 0.57 px at most, 0.37 beyond 8 px of the edge, flows up to
    2.5 px)."""
    h, w = 64, 96
    jcfg = jpwcnet.PWCNetConfig(**SMALL, cost_volume_impl="xla")
    tree = jpwcnet.init_params(jax.random.PRNGKey(1), jcfg)
    cfg = pwcnet.PWCNetConfig(**SMALL)
    model = params.pwcnet_from_jax(_np_tree(tree), cfg, device="cpu")
    monkeypatch.setattr(jpwcnet, "_feature_grid",
                        lambda fh, fw: (2, 2) if (fh, fw) == (h, w) else None)
    monkeypatch.setattr(jpwcnet, "_estimator_grid",
                        lambda eh, ew: (2, 2) if (eh, ew) == (h // 4, w // 4) else None)
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(0, 1, size=(1, h, w, 3)).astype(np.float32) for _ in range(2))

    def held(got, want, band, atol):
        np.testing.assert_allclose(got[:, band:-band, band:-band],
                                   want[:, band:-band, band:-band], rtol=0, atol=atol)
        assert np.abs(got - want).max() > 1e-3

    # the feature block's halo of 6 px is 3 at its output; level 2 reads
    # level 1's 2-px band and stays inside 3 px of its own
    want = jpwcnet.extract_features(tree, jnp.asarray(a), jcfg)
    with torch.no_grad():
        got = pwcnet.extract_features(model, torch.from_numpy(a), cfg)
    for lvl in (1, 2):
        held(got[lvl].numpy(), np.asarray(want[lvl]), 3, 1e-5)
    # the estimator's 6 convs: a band of 6 px
    x = rng.uniform(0, 1, size=(1, h // 4, w // 4, pwcnet._estimator_channels(cfg, 2)))
    x = x.astype(np.float32)
    want = jpwcnet._estimate_tiled(tree["flow"]["level_2"], jnp.asarray(x), jcfg, jpwcnet.F32)
    with torch.no_grad():
        got = pwcnet._estimate(model.flow["level_2"], torch.from_numpy(x), cfg, pwcnet.F32)
    for g, wt in zip(got, want):
        held(g.numpy(), np.asarray(wt), 6, 1e-4)
    want, _ = jpwcnet.apply(tree, jnp.asarray(a), jnp.asarray(b), jcfg)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(a), torch.from_numpy(b))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff[:, 8:-8, 8:-8].max() < diff.max() <= 1.0, diff.max()


def test_param_names_follow_jax_key_paths_and_round_trip():
    tree = _np_tree(jpwcnet.init_params(jax.random.PRNGKey(2),
                                        jpwcnet.PWCNetConfig(**SMALL)))
    model = params.pwcnet_from_jax(tree, pwcnet.PWCNetConfig(**SMALL), device="cpu")
    names = set(dict(model.named_parameters()))
    assert {"feat.level_1.a.weight", "flow.level_4.conv0.weight",
            "ctx.level_2.dc7.bias", "up.level_3.feat.weight"} <= names
    # TF conv2d_transpose [4, 4, out, in] -> torch [in, out, 4, 4]
    assert tuple(model.up["level_3"]["feat"].weight.shape) == tree["up"]["level_3"]["feat"]["w"].shape[::-1][:2] + (4, 4)
    back = params.to_jax_tree(model)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def test_from_tf_vars_rejects_incomplete_or_misshapen_trees():
    shapes = params._tf_shapes(pwcnet.PWCNet(pwcnet.PWCNetConfig(**SMALL), device="cpu"),
                               params.pwcnet_name_map(4, 2))
    tf_vars = deterministic_tf_vars(shapes)
    cfg = pwcnet.PWCNetConfig(**SMALL)
    params.from_tf_vars(tf_vars, "pwcnet", cfg, device="cpu")
    with pytest.raises(KeyError):
        params.from_tf_vars({k: v for k, v in tf_vars.items() if "ctxt" not in k},
                            "pwcnet", cfg, device="cpu")
    bad = dict(tf_vars)
    bad["pwcnet/featpyr/conv1a/kernel"] = np.zeros((3, 3, 4, 16), np.float32)
    with pytest.raises(ValueError, match="shape"):
        params.from_tf_vars(bad, "pwcnet", cfg, device="cpu")
