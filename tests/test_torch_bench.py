"""``sudo-torch-bench`` and ``python -m sudo_rm_rf_tpu_torch.bench`` on the
CPU at toy widths: the rows and the headline carry the JAX package's keys
(``sudo_rm_rf_tpu/utils/benchmark.py::benchmark_model``, root ``bench.py``),
the FLOP count does not depend on the impl or dtype, the zoo builds every
row (the baselines at their published configurations, on the meta device
here), a baseline row runs through its module forward with its LSTMs'
FLOPs counted, and asking for CUDA without it raises.
Times here are the CPU's and mean nothing; the card's are in PERF.md.
"""

import json

import pytest
import torch

from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.cli import bench as bench_cli
from sudo_rm_rf_tpu_torch.utils import benchmark
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

TOY = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
           enc_kernel_size=21, enc_num_basis=16, num_sources=2)
TOY_DPRNN = dict(enc_dim=16, feature_dim=8, hidden_dim=8, layer=1, segment_size=10, win_len=16)
# the keys of a row of sudo-tpu-bench (utils/benchmark.py:221-282), mfu_pct
# aside (off a known card neither package writes it)
JAX_ROW_KEYS = {"batch_size", "timelength", "n_params_m", "measure", "path", "dtype",
                "secs_per_batch", "examples_per_sec", "audio_sec_per_sec",
                "gflops_per_batch", "memory", "model"}
# the keys of the root bench.py's line (bench.py:164-206)
JAX_HEADLINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "config", "headline_fidelity_db",
    "bf16_fidelity_db", "fidelity_gate_db", "conservative_bs4_fp32", "int8_bs8",
    "int8_fidelity_db", "int8_gate_db", "int8_scales", "mfu_pct", "mfu_pct_conservative",
    "train_config", "train_ms_per_step", "train_au_s_per_s", "train_vs_baseline",
    "train_mfu_pct"}


@pytest.fixture
def toy_zoo(monkeypatch):
    toys = {
        "toy": lambda: models.get_model("relu", **TOY),
        "toy_gc": lambda: models.get_model("groupcomm_v2", **TOY, group_size=4),
        "dprnn": lambda: models.get_model("dprnn", **TOY_DPRNN),
    }
    monkeypatch.setattr(benchmark, "reference_model_zoo", lambda: toys)
    return toys


def _rows(capsys, argv):
    assert bench_cli.main(argv + ["--timelength", "0.1", "--device", "cpu"]) == 0
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("extra", [
    [], ["--path", "apply"], ["--dtype", "bfloat16"], ["--path", "apply", "--dtype", "bfloat16"],
    ["--measures", "backward"]], ids=["serving", "apply", "serving_bf16", "apply_bf16",
                                      "backward"])
def test_bench_rows_carry_the_jax_keys(capsys, toy_zoo, extra):
    rows = _rows(capsys, ["--models", "toy", "toy_gc", "--batch_sizes", "1", "2"] + extra)
    assert [(r["model"], r["batch_size"]) for r in rows] == [
        ("toy", 1), ("toy", 2), ("toy_gc", 1), ("toy_gc", 2)]
    for r in rows:
        assert JAX_ROW_KEYS <= set(r) and "mfu_pct" not in r and r["device"] == "cpu"
        assert r["secs_per_batch"] > 0 and r["gflops_per_batch"] > 0 and r["memory"] == {}
        assert r["measure"] == ("backward" if "backward" in extra else "forward")
        assert r["dtype"] == ("bfloat16" if "bfloat16" in extra else "float32")


def test_bench_flops_do_not_depend_on_the_impl(capsys, toy_zoo):
    """The FLOPs of a forward row are those of the plain forward, whatever
    path and dtype run it; a backward row counts three module forwards."""
    got = {}
    for extra in ([], ["--path", "apply"], ["--dtype", "bfloat16"], ["--measures", "backward"]):
        (row,) = _rows(capsys, ["--models", "toy", "--batch_sizes", "2"] + extra)
        got[" ".join(extra)] = row["gflops_per_batch"]
    fwd = got[""]
    assert got["--path apply"] == got["--dtype bfloat16"] == fwd
    assert got["--measures backward"] == pytest.approx(3 * fwd)
    # the fma serving forward, counted itself, misses the depthwise convs it
    # does as multiply-adds: which is why the plain forward is counted
    toy = models.get_model("relu", **TOY)
    fma = benchmark.count_flops(
        benchmark.serving_forward(toy, impl="fma"), benchmark.on_meta(toy),
        torch.empty((2, 1, 800), device="meta"))
    assert fma < fwd * 1e9


def test_bench_zoo_and_unknown_names(capsys, toy_zoo):
    assert bench_cli.main(["--models", "absent", "--device", "cpu"]) == 1
    assert "unknown model absent" in capsys.readouterr().err
    # a baseline row: its module forward, in fp32 and bf16, and a backward
    # row; the FLOPs hold its LSTMs (8 H (I + H) T a direction and layer)
    rows = _rows(capsys, ["--models", "dprnn", "--batch_sizes", "2", "--dtype", "bfloat16"])
    rows += _rows(capsys, ["--models", "dprnn", "--batch_sizes", "2", "--measures",
                           "backward"])
    assert [(r["model"], r["dtype"], r["measure"]) for r in rows] == [
        ("dprnn", "bfloat16", "forward"), ("dprnn", "float32", "backward")]
    # 0.1 s: 99 frames in 22 chunks of 10; the intra and the inter LSTM each
    # run 22 x 10 steps a direction at batch 2, both directions
    lstm_gflops = 2 * (8 * 8 * (8 + 8)) * (2 * 2 * 22 * 10) / 1e9
    assert rows[0]["gflops_per_batch"] > lstm_gflops
    assert rows[1]["gflops_per_batch"] == pytest.approx(3 * rows[0]["gflops_per_batch"])


def test_reference_zoo_builds_the_sudormrf_rows():
    zoo = benchmark.reference_model_zoo()
    assert len(zoo) == 14
    built = {"sudormrf_R4", "sudormrf_R8", "sudormrf_R16", "sudormrf_R16_B2048",
             "sudormrf_R36_B2048", "sudormrf_R36_B4096", "groupcomm_R16", "attentive_v2",
             "attentive_v3"}
    assert benchmark.count_params(zoo["groupcomm_R16"]()) == 565_073
    assert benchmark.count_params(zoo["sudormrf_R36_B4096"]()) == 26_460_745
    for name in ("attentive_v2", "attentive_v3"):
        model = zoo[name]()
        assert (model.variant, model.n_heads, model.att_dims, model.num_blocks) == (
            name[-2:], 4, 256, 16)
    # and the baselines, at their published configurations (on the meta
    # device: Demucs holds 415 M params)
    with torch.device("meta"):
        counts = {name: benchmark.count_params(zoo[name]()) for name in set(zoo) - built}
    assert counts == {"convtasnet": 5_050_545, "dprnn": 2_633_729, "demucs": 415_090_082,
                      "tdcn": 8_628_038, "sepformer": 25_679_361}


def test_bench_profile_dir_writes_a_trace(tmp_path, capsys, toy_zoo):
    rows = _rows(capsys, ["--models", "toy", "--batch_sizes", "2", "--profile_dir",
                          str(tmp_path)])
    assert rows[-1] == {"profile_trace": str(tmp_path / "toy.json")}
    assert json.load(open(tmp_path / "toy.json"))["traceEvents"]


def test_mfu_reads_the_h100_peaks(monkeypatch):
    assert benchmark.chip_peak_flops("bfloat16", "cpu") is None
    assert benchmark.mfu_pct(1e12, 1.0, "float32", "cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert benchmark.chip_peak_flops("bfloat16") == 989e12
    assert benchmark.chip_peak_flops("int8") == 1979e12
    assert benchmark.chip_peak_flops("float32") == 495e12 / 3
    assert benchmark.mfu_pct(989e12, 2.0, "bfloat16") == pytest.approx(50.0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100")
    assert benchmark.chip_peak_flops("bfloat16") is None


def test_headline_prints_the_root_bench_keys(capsys):
    from sudo_rm_rf_tpu_torch import bench

    assert bench.main(["--device", "cpu"], hp=TOY, seconds=0.25, reps=1) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JAX_HEADLINE_KEYS <= set(line)
    assert line["unit"] == "audio-sec/sec/chip" and line["device"] == "cpu"
    assert line["config"] in ("bs4_fp32_kernel", "bs8_bf16_module", "bs8_int8")
    assert line["bf16_gate_passed"] == (line["bf16_fidelity_db"] >= 35.0)
    assert line["int8_gate_passed"] == (line["int8_fidelity_db"] >= 25.0)
    assert line["mfu_pct"] is None and line["train_mfu_pct"] is None  # no card peak
    assert line["train_config"].endswith("_auto")


def test_bench_and_headline_raise_without_cuda(monkeypatch, toy_zoo):
    from sudo_rm_rf_tpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench_cli.main(["--models", "toy"])
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench.main([], hp=TOY)
    with pytest.raises(RuntimeError, match="no CUDA"):
        benchmark.benchmark_model(models.get_model("relu", **TOY))
