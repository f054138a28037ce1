"""``sudo-torch-export`` and the serving CLIs on msgpack checkpoints, against
the JAX package's CLIs, on the CPU.

The checkpoints are the JAX package's own: a whole ``TrainState`` saved by
its ``CheckpointManager`` and a bare param tree, from the JAX init of toy
Improved and GroupComm models. Tolerances: the exported state_dicts equal
(the same keys, bit-equal tensors); separated int16 wavs within 1 LSB;
SI-SDR and SI-SDRi means and medians within 1e-3 dB, BSS-eval at one filter
tap within 1e-2 dB (as tests/test_torch_evaluate.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.parallel import make_mesh
from sudo_rm_rf_tpu.train import trainer as jtrainer
from sudo_rm_rf_tpu.utils import checkpoint as jcheckpoint
from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

HP = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
          enc_kernel_size=21, enc_num_basis=16)
SI_TOL, BSS_TOL = 1e-3, 1e-2


def _hp_argv(model_type):
    argv = [a for k, v in HP.items() for a in (f"--{k}", str(v))]
    return argv + (["--group_size", "4"] if model_type == "groupcomm_v2" else [])


def _jax_checkpoint(tmp_path, model_type, saved):
    """A JAX msgpack checkpoint of the JAX init: a TrainState or bare params."""
    kw = dict(HP, num_sources=2, **({"group_size": 4} if model_type == "groupcomm_v2" else {}))
    model = jmodels.get_model(model_type, **kw)
    params = model.init(jax.random.key(1), jnp.zeros((1, 1, 800)))["params"]
    manager = jcheckpoint.CheckpointManager(str(tmp_path / "jax_ckpt"), model_type)
    if saved == "params":
        return manager.save(params, "params")
    trainer = jtrainer.Trainer(model, jtrainer.TrainerConfig(),
                               mesh=make_mesh(devices=jax.devices()[:1]))
    return manager.save(trainer.state_from_params(params), f"{model_type}_epoch_1")


@pytest.mark.parametrize("saved", ["train_state", "params"])
@pytest.mark.parametrize("model_type", ["relu", "groupcomm_v2"])
def test_export_matches_jax_export(tmp_path, capsys, model_type, saved):
    from sudo_rm_rf_tpu.cli.export import main as jax_main
    from sudo_rm_rf_tpu_torch.cli.export import main

    ckpt = _jax_checkpoint(tmp_path, model_type, saved)
    argv = ["--checkpoint", ckpt, "--model_type", model_type, *_hp_argv(model_type)]
    assert jax_main(argv + ["--out", str(tmp_path / "jax.pt")]) == 0
    assert main(argv + ["--out", str(tmp_path / "port.pt")]) == 0
    assert "(%d tensors)" % len(torch.load(tmp_path / "jax.pt")) in capsys.readouterr().out
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    assert list(got) and sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_export_rejects_a_checkpoint_of_other_widths(tmp_path):
    from sudo_rm_rf_tpu_torch.cli.export import main

    ckpt = _jax_checkpoint(tmp_path, "relu", "params")
    with pytest.raises(RuntimeError, match="size mismatch"):
        main(["--checkpoint", ckpt, "--out", str(tmp_path / "x.pt"),
              *_hp_argv("relu")[:-2], "--enc_num_basis", "24"])


def test_sudo_torch_export_is_a_console_script():
    import tomllib

    with open(os.path.join(os.path.dirname(__file__), "..", "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["sudo-torch-export"] == "sudo_rm_rf_tpu_torch.cli.export:main"


@pytest.mark.parametrize("saved", ["train_state", "params"])
def test_separate_msgpack_matches_jax_cli(tmp_path, saved):
    from sudo_rm_rf_tpu.cli.separate import main as jax_main
    from sudo_rm_rf_tpu_torch.cli.separate import main

    ckpt = _jax_checkpoint(tmp_path, "relu", saved)
    wav = str(tmp_path / "mix.wav")
    x = np.cumsum(np.random.default_rng(4).standard_normal((2, 6000)), axis=-1)
    x = (x / np.abs(x).max(axis=-1, keepdims=True)).sum(0) / 2
    wavfile.write(wav, 8000, (x * 32767).astype(np.int16))
    common = ["--checkpoint", ckpt, "--input", wav, "--chunk_seconds", "0.4",
              "--batch_chunks", "2", *_hp_argv("relu")]
    assert jax_main(common + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert main(common + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    for s in (1, 2):
        _, want = wavfile.read(tmp_path / "jax" / f"mix_s{s}.wav")
        _, got = wavfile.read(tmp_path / "port" / f"mix_s{s}.wav")
        assert got.shape == want.shape == (6000,) and got.dtype == np.int16
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def _summaries(capsys, argv):
    from sudo_rm_rf_tpu.cli.evaluate import main as jax_main
    from sudo_rm_rf_tpu_torch.cli.evaluate import main

    out = []
    for fn, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        assert fn(argv + extra) == 0
        out.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    return out


def _assert_summaries_close(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, float):
            tol = SI_TOL if key.startswith("si_sdr") else BSS_TOL
            assert abs(got[key] - w) <= tol, (key, got[key], w)
        else:
            assert got[key] == w, key


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    # seed 3: no target is silent over the 0.5 s crops
    return write_hierarchical_corpus(str(tmp_path_factory.mktemp("hier")), 0, 0, 3, 2, 3,
                                     seconds=1.0, seed=3)


@pytest.mark.parametrize("model_type", ["relu", "groupcomm_v2"])
def test_evaluate_augmented_msgpack_matches_jax_cli(tmp_path, capsys, corpus, model_type):
    ckpt = _jax_checkpoint(tmp_path, model_type, "train_state")
    argv = ["--checkpoint", ckpt, "--model_type", model_type, "--dataset", "AUGMENTED",
            "--dataset_paths", os.path.join(corpus, "test"), "--n_samples", "6",
            "--timelength", "0.5", "--batch_size", "2", "--bss_filter_taps", "1",
            *_hp_argv(model_type)]
    want, got = _summaries(capsys, argv)
    assert got["n_examples"] == 6
    _assert_summaries_close(got, want)
