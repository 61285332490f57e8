"""Port: the CLI's flags against the JAX CLI's, and its PWC-Net checkpoint
route (`--pwc_ckpt`, the default look at <checkpoint_dir>/pwcnet), on the CPU.

Every flag of fisr_tpu/cli/main.py's parser but --jax_cache_dir parses on the
port with the same default, so a reference command line runs on both.
"""

import os

import numpy as np
import pytest
import torch

from fisr_tpu.cli.main import parse_args as jax_parse_args
from fisr_tpu_torch.cli import main as cli
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_jax_flag_parses_with_its_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the JAX parser makes its default directories
    want = vars(jax_parse_args([]))
    want.pop("jax_cache_dir")
    got = vars(cli.parse_args([]))
    assert {k: got.get(k, "<missing>") for k in want} == want
    reference = ["--net_type", "FISRnet", "--FISR_input_size", "540", "960",
                 "--pwc_ckpt", "ck/pwcnet", "--fisr_tf_ckpt", "a/FISRnet-1",
                 "--pwc_tf_ckpt", "b/pwcnet.ckpt-2", "--phase", "test"]
    j, p = vars(jax_parse_args(reference)), vars(cli.parse_args(reference))
    assert {k: p[k] for k in want} == {k: j[k] for k in want}


def _args(tmp_path, *flags):
    return cli.parse_args(["--checkpoint_dir", str(tmp_path / "ck"), "--device", "cpu",
                           *flags])


def _save_pwc(directory, steps_metrics):
    """Port-format PWC-Net checkpoints of the oracle generator's weights, the
    step added to one bias so the steps differ."""
    mgr = CheckpointManager(str(directory), max_to_keep=10, best_mode="min")
    for step, metric in steps_metrics:
        tree = params.to_jax_tree(params.deterministic_pwcnet(device="cpu"))
        tree["up"]["level_3"]["flow"]["b"] = tree["up"]["level_3"]["flow"]["b"] + step
        mgr.save(step, {"params": tree, "step": np.asarray(step)}, metric=metric)


def _bias(model):
    return float(model.up.level_3.flow.bias[0].detach())


def test_pwc_weights_come_from_the_best_checkpoint(tmp_path, capsys):
    _save_pwc(tmp_path / "ck" / "pwcnet", [(10, 0.5), (20, 0.2), (30, 0.9)])
    base = _bias(params.deterministic_pwcnet(device="cpu"))
    # the default look at <checkpoint_dir>/pwcnet takes the least metric
    model = cli._model(_args(tmp_path), "cpu", "pwc")
    assert _bias(model) == pytest.approx(base + 20)
    assert " [*] restored PWC-Net checkpoint step 20 from " in capsys.readouterr().out
    # --pwc_ckpt names another directory
    _save_pwc(tmp_path / "other", [(7, None)])
    model = cli._model(_args(tmp_path, "--pwc_ckpt", str(tmp_path / "other")), "cpu", "pwc")
    assert _bias(model) == pytest.approx(base + 7)
    # weights named by a flag win over both
    model = cli._model(_args(tmp_path, "--deterministic_weights"), "cpu", "pwc")
    assert _bias(model) == pytest.approx(base)
    with pytest.raises(FileNotFoundError, match="--pwc_ckpt"):
        cli._model(_args(tmp_path, "--pwc_ckpt", str(tmp_path / "none")), "cpu", "pwc")


def test_orbax_and_tf_checkpoints_raise_not_ported(tmp_path):
    # the repo's trained PWC-Net is an orbax store: its reader is Queue 1 item 6
    orbax = os.path.join(ROOT, "checkpoint_dir")
    with pytest.raises(NotImplementedError, match="item 6"):
        cli._model(cli.parse_args(["--checkpoint_dir", orbax]), "cpu", "pwc")
    for what in ("fisr", "pwc"):
        with pytest.raises(NotImplementedError, match="item 6"):
            cli._model(_args(tmp_path, f"--{what}_tf_ckpt", "x/ckpt-1"), "cpu", what)


def test_main_prints_the_reference_lines(tmp_path, capsys):
    with pytest.raises(SystemExit, match="weights"):
        cli.main(["--checkpoint_dir", str(tmp_path / "none"), "--device", "cpu",
                  "--frame_folder_path", str(tmp_path)])
    assert "Model: FISRnet, phase: FISR_for_video, exp: 1" in capsys.readouterr().out
