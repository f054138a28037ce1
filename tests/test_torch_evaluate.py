"""``sudo-torch-evaluate`` against ``sudo_rm_rf_tpu.cli.evaluate.main`` on the
CPU: the same state_dict ``.pt`` and the same synthetic corpus give the same
summary, in crop mode and with ``--full_length``, for the Improved and
GroupComm models, with BSS-eval at 1 and 512 filter taps; the options that
wait raise; and the CLI runs without importing JAX.

Tolerances: SI-SDR and SI-SDRi means and medians within 1e-3 dB, BSS-eval
SDR/SDRi/SIR/SAR within 1e-2 dB at filter_taps 1 and 5e-2 dB at 512; counts
and notes exactly. The JAX CLI runs the model's plain blocks and XLA's
solve, the port the fma blocks and LAPACK's. At 512 taps the fp32 solve of
the 1024 x 1024 Gram of band-limited voices is itself only ~1e-3 accurate
(relative, against float64), so the two solves part by hundredths of a dB.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.data.synthetic import write_fuss_corpus, write_whamr_corpus
from sudo_rm_rf_tpu_torch.utils import CheckpointManager
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
          enc_kernel_size=21, enc_num_basis=16)
SI_TOL = 1e-3
FUSS_SEED = 9


# the seeds give no target that is silent over a crop (the voices' syllabic
# gates can switch off for a whole short clip; BSS-eval then has a singular
# Gram in both packages)
@pytest.fixture(scope="module")
def whamr_root(tmp_path_factory):
    return write_whamr_corpus(str(tmp_path_factory.mktemp("whamr")), n_train=0, n_val=0,
                              n_test=4, seconds=(0.75, 1.0), fs=8000, seed=6)


@pytest.fixture(scope="module")
def fuss_root(tmp_path_factory):
    return write_fuss_corpus(str(tmp_path_factory.mktemp("fuss")), n_train=0, n_val=0,
                             n_eval=8, seconds=0.75, seed=FUSS_SEED)


def _checkpoint(tmp_path, model_type, num_sources=2, **extra):
    model = models.get_model(model_type, **HP, num_sources=num_sources, **extra,
                             generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / f"{model_type}.pt")
    torch.save(model.state_dict(), path)
    return path


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _argv(ckpt, model_type, root, extra):
    argv = ["--checkpoint", ckpt, "--model_type", model_type, "--root_dirpath", root,
            "--timelength", "0.75", "--batch_size", "2"]
    for k, v in HP.items():
        argv += [f"--{k}", str(v)]
    return argv + extra


def _compare(tmp_path, capsys, model_type, root, extra, taps, num_sources=2, **model_kw):
    from sudo_rm_rf_tpu.cli.evaluate import main as jax_main
    from sudo_rm_rf_tpu_torch.cli.evaluate import main

    ckpt = _checkpoint(tmp_path, model_type, num_sources, **model_kw)
    argv = _argv(ckpt, model_type, root, extra + ["--bss_filter_taps", str(taps)])
    want = _run(jax_main, argv, capsys)
    got = _run(main, argv + ["--device", "cpu"], capsys)
    assert sorted(got) == sorted(want)
    bss_tol = 1e-2 if taps == 1 else 5e-2
    for key, w in want.items():
        if isinstance(w, float):
            tol = SI_TOL if key.startswith("si_sdr") else bss_tol
            assert abs(got[key] - w) <= tol, (key, got[key], w)
        else:
            assert got[key] == w, key
    return got


WHAMR = ["--dataset", "WHAMR", "--separation_task", "noisy_reverberant", "-fs", "8000"]


@pytest.mark.parametrize("taps", [1, 512])
def test_evaluate_relu_whamr_crops_matches_jax(tmp_path, capsys, whamr_root, taps):
    got = _compare(tmp_path, capsys, "relu", whamr_root, WHAMR, taps)
    assert got["n_examples"] == 4 and got["bss_eval_filter_taps"] == taps
    assert ("bss_eval_note" in got) == (taps < 512)


def test_evaluate_relu_whamr_full_length_matches_jax(tmp_path, capsys, whamr_root):
    got = _compare(tmp_path, capsys, "relu", whamr_root, WHAMR + ["--full_length"], 1)
    assert got["n_examples"] == 4


@pytest.mark.parametrize("extra", [[], ["--full_length"]], ids=["crops", "full_length"])
def test_evaluate_groupcomm_matches_jax(tmp_path, capsys, whamr_root, extra):
    _compare(tmp_path, capsys, "groupcomm_v2", whamr_root,
             WHAMR + extra + ["--group_size", "4", "--mixture_consistency", "uniform"], 1,
             group_size=4)


FUSS = ["--dataset", "FUSS", "-fs", "16000", "--num_sources", "4",
        "--mixture_consistency", "uniform"]


def _jax_bss_eval_reporting_the_scored_assignment(est, targets, mixture, eps=1e-10,
                                                 filter_taps=1):
    """The JAX package's ``bss_eval_improvement``, reporting each target
    against the estimate its best permutation scored it with (the port's
    repair, ``losses/bss_eval.py``): the estimates are first put in that
    order, where the best permutation is the identity, which JAX reports
    right."""
    import jax.numpy as jnp

    from sudo_rm_rf_tpu.losses import bss_eval as jbss

    perm = jbss.bss_eval_sources(est, targets, eps, filter_taps=filter_taps)["perm"]
    order = jnp.argsort(perm, axis=-1)
    est = jnp.take_along_axis(jnp.asarray(est), order[..., None], axis=1)
    return jbss.bss_eval_improvement(est, targets, mixture, eps, filter_taps=filter_taps)


def test_evaluate_fuss_four_source_examples_match_jax(tmp_path, capsys, fuss_root,
                                                      monkeypatch):
    """The examples of four sources of a FUSS eval split. With four sources
    the port's BSS-eval reports the scored assignment where the JAX
    package's does not (ROADMAP queue 3), so the JAX CLI runs with its own
    BSS-eval put in the same order."""
    import shutil

    import sudo_rm_rf_tpu.losses

    monkeypatch.setattr(sudo_rm_rf_tpu.losses, "bss_eval_improvement",
                        _jax_bss_eval_reporting_the_scored_assignment)

    root = tmp_path / "fuss4"
    shutil.copytree(fuss_root, root)
    lines = (root / "eval_example_list.txt").read_text().split("\n")
    (root / "eval_example_list.txt").write_text(
        "\n".join(line for line in lines if len(line.split()) == 5) + "\n")
    got = _compare(tmp_path, capsys, "relu", str(root), FUSS, 1, num_sources=4)
    assert got["n_examples"] == 2 and np.isfinite(got["si_sdri_mean"])


def test_evaluate_fuss_scores_padded_rows_as_the_jax_cli_does(tmp_path, capsys, fuss_root):
    """An example of fewer than --num_sources sources keeps zero rows in its
    target stack. The JAX CLI scores them (a zero target's SI-SDR is -inf,
    which its one-hot permutation einsum turns into NaN), so its means are
    NaN. The port departs from it: each example is scored over its active
    sources only, as training's per-source-count validation does, so every
    mean is finite; one-source examples add no SI-SDRi or SDRi."""
    import pickle

    from sudo_rm_rf_tpu.cli.evaluate import main as jax_main
    from sudo_rm_rf_tpu_torch.cli.evaluate import main

    argv = _argv(_checkpoint(tmp_path, "relu", 4), "relu", fuss_root,
                 FUSS + ["--bss_filter_taps", "1"])
    want = _run(jax_main, argv, capsys)
    out = tmp_path / "fuss.pkl"
    got = _run(main, argv + ["--device", "cpu", "--out_pickle", str(out)], capsys)
    assert got["n_examples"] == want["n_examples"] == 8
    assert np.isnan(want["si_sdr_mean"])
    assert all(np.isfinite(v) for k, v in got.items() if k.endswith(("_mean", "_median")))
    # each line of the list: the mixture, then the example's sources
    counts = [len(line.split()) - 1 for line in
              open(os.path.join(fuss_root, "eval_example_list.txt")).read().strip().split("\n")]
    assert min(counts) == 1 and max(counts) == 4
    res = pickle.load(open(out, "rb"))
    multi = sum(c > 1 for c in counts)
    assert [len(res[k]) for k in ("si_sdr", "sdr", "sir", "sar")] == [8] * 4
    assert len(res["si_sdri"]) == len(res["sdri"]) == multi


def test_fuss_scores_take_the_active_sources():
    """``fuss_scores`` on estimates that hold each example's sources in
    shuffled slots: every example separates perfectly, whatever its count."""
    from sudo_rm_rf_tpu_torch.cli.evaluate import fuss_scores

    rng = np.random.default_rng(5)
    t = 800
    tgt = np.zeros((4, 4, t), np.float32)
    est = 1e-3 * rng.standard_normal((4, 4, t)).astype(np.float32)
    for i, n in enumerate((1, 2, 3, 4)):
        src = np.cumsum(rng.standard_normal((n, t)), axis=-1).astype(np.float32)
        tgt[i, :n] = src
        slots = [0] if n == 1 else rng.permutation(4)[:n]
        est[i, slots] += src
    tt, et = torch.from_numpy(tgt), torch.from_numpy(est)
    got = fuss_scores(et, tt, tt.sum(1, keepdim=True), taps=1)
    assert len(got["si_sdr"]) == len(got["sdr"]) == 4
    assert len(got["si_sdri"]) == len(got["sdri"]) == 3
    assert min(got["si_sdr"]) > 30 and min(got["sdr"]) > 30
    assert all(np.isfinite(v).all() for v in got.values())


def test_evaluate_writes_the_per_example_pickle(tmp_path, capsys, whamr_root):
    import pickle

    from sudo_rm_rf_tpu_torch.cli.evaluate import main

    out = tmp_path / "res.pkl"
    argv = _argv(_checkpoint(tmp_path, "relu"), "relu", whamr_root,
                 WHAMR + ["--bss_filter_taps", "1", "--out_pickle", str(out), "--device", "cpu"])
    summary = _run(main, argv, capsys)
    res = pickle.load(open(out, "rb"))
    assert sorted(res) == ["sar", "sdr", "sdri", "si_sdr", "si_sdri", "sir"]
    assert all(len(v) == 4 and np.isfinite(v).all() for v in res.values())
    assert summary["si_sdri_median"] == float(np.median(res["si_sdri"]))


@pytest.mark.parametrize("extra,error,match", [
    (["--full_length", "--full_length_mode", "seq_parallel", "--model_type", "attention_v3"],
     SystemExit, "seq_parallel supports model_type in .*attention_v3 falls back"),
    (["--dataset", "AUGMENTED"], SystemExit, "--dataset_paths is required"),
    (["--model_type", "dprnn"], ValueError, "ROADMAP queue 3"),
    (["--model_type", "sepformer"], ValueError, "ROADMAP queue 3"),
    (["--device", "cuda"], RuntimeError, "no CUDA"),
])
def test_evaluate_raises_for_what_waits(tmp_path, whamr_root, monkeypatch, capsys, extra,
                                       error, match):
    """Each refusal names its reason, in the exception or, for argparse's
    ``p.error`` (as the JAX CLI refuses), on stderr."""
    import re

    from sudo_rm_rf_tpu_torch.cli.evaluate import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(_checkpoint(tmp_path, "relu"), "relu", whamr_root, WHAMR)
    if "--device" not in extra:
        argv += ["--device", "cpu"]
    with pytest.raises(error) as info:
        main(argv + extra)
    assert re.search(match, f"{info.value} {capsys.readouterr().err}")


def test_evaluate_takes_a_msgpack_checkpoint(tmp_path, capsys, whamr_root):
    """The weights of a ``.pt`` saved as a msgpack TrainState (the layout
    both packages' CheckpointManager write) give the same summary; msgpack
    checkpoints waited until the checkpoint bridge was ported."""
    from sudo_rm_rf_tpu_torch.cli.evaluate import main
    from sudo_rm_rf_tpu_torch.train.trainer import Trainer

    pt = _checkpoint(tmp_path, "relu")
    model = models.get_model("relu", **HP)
    model.load_state_dict(torch.load(pt, weights_only=True))
    msgpack = str(tmp_path / "relu_epoch_1")
    CheckpointManager(str(tmp_path), "relu").save(Trainer(model).init_state(), "relu_epoch_1")
    extra = WHAMR + ["--bss_filter_taps", "1", "--device", "cpu"]
    want = _run(main, _argv(pt, "relu", whamr_root, extra), capsys)
    got = _run(main, _argv(msgpack, "relu", whamr_root, extra), capsys)
    assert got == want and got["n_examples"] == 4


def test_evaluate_defaults_match_the_jax_cli():
    from sudo_rm_rf_tpu.cli import evaluate as jev
    from sudo_rm_rf_tpu_torch.cli.evaluate import build_parser

    got = vars(build_parser().parse_args(["--checkpoint", "m.pt"]))
    assert got.pop("device") == "cuda"
    # the JAX CLI builds its parser inside main: read its defaults from there
    seen = {}

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen.update(vars(real(self, args, namespace)))
        raise Stop

    import argparse

    real = argparse.ArgumentParser.parse_args
    try:
        argparse.ArgumentParser.parse_args = capture
        with pytest.raises(Stop):
            jev.main(["--checkpoint", "m.pt"])
    finally:
        argparse.ArgumentParser.parse_args = real
    assert got == seen


def test_sudo_torch_evaluate_is_a_console_script():
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["sudo-torch-evaluate"] == "sudo_rm_rf_tpu_torch.cli.evaluate:main"


def test_evaluate_imports_no_jax(tmp_path, whamr_root):
    """In a fresh interpreter, ``sudo-torch-evaluate`` scores a WHAMR split
    in crop and full-length mode on the CPU without importing JAX or any
    module of the JAX package, and asking for CUDA where there is none
    raises."""
    ckpt = _checkpoint(tmp_path, "relu")
    code = textwrap.dedent("""
        import json, sys
        import torch
        from sudo_rm_rf_tpu_torch.cli import evaluate
        from sudo_rm_rf_tpu_torch.losses import bss_eval, functional, norm, snr
        from sudo_rm_rf_tpu_torch.data import fuss, whamr
        argv = json.loads(sys.argv[1])
        assert evaluate.main(argv + ["--device", "cpu"]) == 0
        assert evaluate.main(argv + ["--device", "cpu", "--full_length"]) == 0
        foreign = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "sudo_rm_rf_tpu"))
        assert not foreign, foreign
        if not torch.cuda.is_available():
            try:
                evaluate.main(argv)  # --device defaults to cuda
            except RuntimeError:
                print("EVAL-OK")
    """)
    argv = _argv(ckpt, "relu", whamr_root, WHAMR + ["--bss_filter_taps", "1"])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(argv)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "EVAL-OK" in proc.stdout, proc.stdout + proc.stderr
