"""The port's synthetic WHAMR! and FUSS writers (``data.synthetic``) and its
hierarchical corpus script write the JAX package's scripts' files byte for
byte (``scripts/make_synthetic_{whamr,fuss,corpus}.py``), at a few 0.5 s
files and the same seed."""

import importlib.util
import os

import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)
from sudo_rm_rf_tpu_torch.data.synthetic import write_fuss_corpus, write_whamr_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_files(a, b) -> int:
    """Asserts that the trees under a and b hold the same files, byte for
    byte; returns their count."""
    names = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for rel in names:
        with open(os.path.join(a, rel), "rb") as x, open(os.path.join(b, rel), "rb") as y:
            assert x.read() == y.read(), rel
    return len(names)


def test_whamr_corpus_matches_the_script(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    _script("make_synthetic_whamr").main(
        ["--out", str(tmp_path / "script"), "--n_train", "2", "--n_val", "1", "--n_test", "2",
         "--seconds", "0.5", "--seed", "3"])
    write_whamr_corpus(str(tmp_path / "port"), 2, 1, 2, seconds=0.5, fs=8000, seed=3)
    assert _same_files(tmp_path / "script", tmp_path / "port") == 5 * 7


def test_fuss_corpus_matches_the_script(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    _script("make_synthetic_fuss").main(
        ["--out", str(tmp_path / "script"), "--n_train", "4", "--n_val", "4", "--n_eval", "2",
         "--seconds", "0.5", "--seed", "3"])
    write_fuss_corpus(str(tmp_path / "port"), 4, 4, 2, seconds=0.5, seed=3)
    # 3 example lists; validation and eval cycle 1..4 sources an example
    assert _same_files(tmp_path / "script", tmp_path / "port") > 3 + 10


@pytest.mark.parametrize("seed", [0, 5])
def test_hierarchical_corpus_script_matches(tmp_path, monkeypatch, seed):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    argv = ["--train_speakers", "2", "--val_speakers", "1", "--test_speakers", "2", "--utts",
            "2", "--val_utts", "1", "--seconds", "0.5", "--seed", str(seed)]
    _script("make_synthetic_corpus").main(["--out", str(tmp_path / "script")] + argv)
    _script("torch_make_synthetic_corpus").main(["--out", str(tmp_path / "port")] + argv)
    assert _same_files(tmp_path / "script", tmp_path / "port") == 2 * 2 + 1 + 2
