"""The port's serving and quality tools, on the CPU at toy size.

``scripts/torch_longform_run.py``'s numpy helpers equal those of
``scripts/longform_run.py`` bit for bit; the roofline's counted FLOPs of a
toy forward equal a closed form of its hparams; the quality cross-check's
three sides (port, JAX, report) agree on a converted random-init
checkpoint; the quickstart trains and separates at a cut of its steps; and
the tools run without JAX and refuse a missing card.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=2,
          enc_kernel_size=21, enc_num_basis=16, num_sources=2)
HP_ARGV = [a for k, v in HP.items() if k != "num_sources" for a in (f"--{k}", str(v))]


def _load(path):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hier"))
    return write_hierarchical_corpus(root, 1, 1, 2, 2, 3, fs=8000, seconds=0.5, seed=0)


def test_longform_helpers_match_the_jax_script(corpus):
    """build_long_sources and pit_si_sdri equal the numpy functions of
    scripts/longform_run.py (defined before its import of JAX) bit for bit."""
    port = _load("scripts/torch_longform_run.py")
    jax_side = _load("scripts/longform_run.py")
    test = os.path.join(corpus, "test")
    want = jax_side.build_long_sources(test, 2.3, 8000)
    got = port.build_long_sources(test, 2.3, 8000)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 18400)
    assert np.array_equal(got, want)
    est = np.random.default_rng(0).standard_normal(want.shape).astype(np.float32)
    mixture = want.sum(axis=0)
    assert port.pit_si_sdri(est, want, mixture) == jax_side.pit_si_sdri(est, want, mixture)
    assert port.pit_si_sdri(want[::-1], want, mixture) == jax_side.pit_si_sdri(
        want[::-1], want, mixture)


def test_roofline_counts_the_closed_form_flops():
    """Products and channel-mixing convs (tensor cores) and depthwise convs
    (fp32 pipes) of a toy forward, against their count from the hparams:
    the encoder (N x K taps an output frame), bottleneck (C x N), each
    block's proj and res (Ci x C each) and depthwise ladder (5 taps a level
    output), the mask head (S N x C) and the transposed decoder (S N x S x K
    a frame); the kernel row counts K1's two products for each block and
    its ladder on the fp32 pipes."""
    roof = _load("scripts/torch_roofline_bound.py")
    model = models.get_model("relu", **HP, generator=torch.Generator().manual_seed(0))
    b, t = 2, 2000
    c, ci, n, s, k = 16, 32, 16, 2, 21
    f = (t + 2 * 10 - k) // 10 + 1
    blocks = 2 * (2 * 2 * b * ci * c * f)
    tensor = 2 * b * n * k * f + 2 * b * c * n * f + blocks + 2 * b * s * n * c * f \
        + 2 * b * s * n * s * k * f
    depthwise = 2 * sum(2 * b * ci * 5 * (f >> lvl) for lvl in range(2))
    xla = roof.row_work(model, "xla", None, b, t)
    assert xla["tensor"] == {"float32": tensor}
    assert xla["depthwise"] == depthwise and xla["fp32_pipes"] > depthwise
    kernel = roof.row_work(model, "kernel", None, b, t)
    assert kernel["tensor"] == {"float32": tensor} and kernel["depthwise"] == 0
    bf16 = roof.row_work(model, "xla", "bfloat16", b, t)
    assert bf16["tensor"] == {"bfloat16": tensor}
    params = sum(p.numel() for p in model.parameters())
    assert xla["least_bytes"] == 4 * params + 4 * b * t * (1 + s)
    assert bf16["least_bytes"] == 2 * params + 4 * b * t * (1 + s)
    assert xla["logical_bytes"] > xla["least_bytes"]


def test_quality_crosscheck_sides_agree(tmp_path, corpus):
    """--side port, then --side jax, then --side report on a converted
    random-init checkpoint (the port's init as a JAX msgpack)."""
    from sudo_rm_rf_tpu.utils import checkpoint as jcheckpoint
    from sudo_rm_rf_tpu_torch.convert import params_to_flax

    model = models.get_model("relu", **HP, generator=torch.Generator().manual_seed(3))
    ckpt = jcheckpoint.CheckpointManager(str(tmp_path / "ckpt"), "relu").save(
        params_to_flax(model), "params")
    qc = _load("scripts/torch_quality_crosscheck.py")
    argv = ["--checkpoint", ckpt, "--corpus", os.path.join(corpus, "test"), "--model_type",
            "relu", "--n_samples", "4", "--batch_size", "2", "--timelength", "0.5",
            "--npz", str(tmp_path / "port.npz"), "--jax_npz", str(tmp_path / "jax.npz"),
            *HP_ARGV]
    port = qc.main(["--side", "port", "--device", "cpu"] + argv)
    assert port["n_examples"] == 4 and port["device"] == "cpu (not a device measurement)"
    qc.main(["--side", "jax"] + argv)
    report = qc.main(["--side", "report"] + argv)
    assert report["abs_delta_db"] < 0.01 and report["output_fidelity_db"] >= 100, report
    assert np.isfinite(report["torch_sisdri_mean"])


def test_quickstart_runs_at_a_cut(capsys):
    out = _load("examples/torch_quickstart.py").main(["--device", "cpu", "--steps", "40"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    assert np.isfinite(out["long_mixture_si_sdr_db"])
    assert out["device"] == "cpu (not a device measurement)"
    assert "long-mixture SI-SDR" in capsys.readouterr().out


def test_tools_import_no_jax_and_refuse_a_missing_card(tmp_path):
    """In a fresh interpreter the eight tools load, and the batch sweep and
    the corpus writer run on the CPU, without loading JAX or the JAX
    package; where there is no card, every tool that runs on a device
    raises when asked for its default one."""
    code = textwrap.dedent(f"""
        import importlib.util, json, os, sys
        import torch

        def load(path):
            spec = importlib.util.spec_from_file_location(
                os.path.basename(path)[:-3], os.path.join({REPO!r}, path))
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module

        tools = {{name: load(path) for name, path in (
            ("batch", "scripts/torch_bench_batch_sweep.py"),
            ("gc", "scripts/torch_bench_gc_serving.py"),
            ("quantized", "scripts/torch_bench_quantized.py"),
            ("roofline", "scripts/torch_roofline_bound.py"),
            ("longform", "scripts/torch_longform_run.py"),
            ("quality", "scripts/torch_quality_crosscheck.py"),
            ("corpus", "scripts/torch_make_synthetic_corpus.py"),
            ("quickstart", "examples/torch_quickstart.py"))}}
        rows = tools["batch"].main(["--device", "cpu", "--tiny", "--bs", "2", "--n_hi", "1",
                                    "--paths", "kernel_fp32", "int8_static"])
        assert [r["path"] for r in rows] == ["kernel_fp32", "int8_static"]
        tools["corpus"].main(["--out", {str(tmp_path / "c")!r}, "--train_speakers", "1",
                              "--val_speakers", "1", "--test_speakers", "1", "--utts", "1",
                              "--val_utts", "1", "--seconds", "0.1"])
        foreign = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "sudo_rm_rf_tpu"))
        assert not foreign, foreign
        refused = []
        if not torch.cuda.is_available():
            for name, argv in (("batch", ["--tiny"]), ("gc", ["--tiny"]),
                               ("quantized", ["--tiny"]), ("roofline", ["--tiny", "--measure"]),
                               ("longform", ["--checkpoint", "absent"]),
                               ("quality", ["--side", "port", "--checkpoint", "absent",
                                            "--corpus", "absent"]),
                               ("quickstart", [])):
                try:
                    tools[name].main(argv)
                except RuntimeError as e:
                    assert "no CUDA device" in str(e), (name, e)
                    refused.append(name)
        print("TOOLS-OK", json.dumps(refused))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240, cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and "TOOLS-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    refused = json.loads(proc.stdout.split("TOOLS-OK", 1)[1].strip().splitlines()[0])
    if not torch.cuda.is_available():
        assert len(refused) == 7, refused
