"""Tests of the benchmark harness. On the CPU at tiny widths: the manifest and
every file it names, the work counters against hand counts, the interval
arithmetic, a cell added as new files only, whole runs of tiny cells with
the check passing and failing under planted faults, and the controls. On
the card (marker ``cuda``, skipped without one): the controls at the cells'
own sizes.

    python -m pytest port_bench -q                 # the CPU tests, ~3 min
    python -m pytest port_bench -q -m cuda         # on the card, ~10 min
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from port_bench import devtrace, faults, manifest, run, work
from port_bench.reference import twins

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CPU = torch.device("cpu")


# ------------------------------------------------------------- the manifest
def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    layers = {m["moves"] for m in BENCH["per_layer"]}
    assert layers <= {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = manifest.load(cell)
    assert c.workload["driver"] in ("serve_clip", "train_step")
    assert c.driver().Driver
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.config["reduced"] == []


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    cell = manifest.load(next(m for m in BENCH["per_layer"] if m["name"] == metric)
                         ["workloads"][0])
    read = cell.reader(metric)
    assert read({"kind": "none"}) is None


def test_categories_load_in_order_and_name_kernels():
    cats = devtrace.load_categories(HERE / "categories")
    assert [c["order"] for c in cats] == sorted(c["order"] for c in cats)
    of = devtrace.Categoriser(cats)
    assert of("void (anonymous namespace)::anchor_wg_kernel<40, 1, false>(Params)") == \
        "k01_attention_hd40"
    assert of("void short_attention_kernel<3, 16, 8>(float*)") == "k03_temporal_attention"
    assert of("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add>") == \
        "elementwise"
    assert of("sm90_xmma_fprop_implicit_gemm_bf16") == "lib_conv"
    assert of("nvjet_tst_128x256_64x4") == "lib_gemm"
    assert of("a kernel nobody named") == devtrace.OTHER
    assert of.group["k02_cross_hd40"] == "attention"


# ------------------------------------------------------- interval arithmetic
def test_union_busy_and_gaps():
    iv = [(0, 10, "a"), (5, 12, "b"), (20, 30, "c"), (30, 31, "d"), (40, 45, "e")]
    assert devtrace.union(iv) == [(0, 12), (20, 31), (40, 45)]
    assert devtrace.busy_ns(iv, 0, 50) == 12 + 11 + 5
    assert devtrace.busy_ns(iv, 6, 42) == 6 + 11 + 2
    assert devtrace.gaps(iv, 0, 50) == [(12, 20), (31, 40), (45, 50)]
    assert devtrace.gaps(iv, -5, 8) == [(-5, 0)]
    named = devtrace.name_gaps([(12, 20), (31, 40), (45, 50)],
                               [("encode", 10, 25), ("decode", 30, 44)])
    assert named == pytest.approx({"encode": 8e-9, "decode": 9e-9,
                                   "host, between spans": 5e-9})


def test_categorise_counts_each_kernel_once_in_the_window():
    of = devtrace.Categoriser(devtrace.load_categories(HERE / "categories"))
    k = [(0, 10, "ln_kernel<8>"), (5, 25, "ln_kernel<8>"), (30, 40, "nvjet_x")]
    assert devtrace.categorise(k, of, 0, 30) == pytest.approx({"k06_layer_norm": 30e-9})
    assert devtrace.categorise(k, of) == pytest.approx({"k06_layer_norm": 30e-9,
                                                        "lib_gemm": 10e-9})


# ----------------------------------------------------------- work counters
def test_flop_counter_matches_hand_counts():
    with torch.device("meta"):
        lin = torch.nn.Linear(40, 24)
        conv = torch.nn.Conv2d(8, 16, 3, padding=1)
        att = twins.TAttention(32, 4)
        assert work._count(lambda: lin(torch.empty(7, 40))) == 2 * 7 * 40 * 24
        assert work._count(lambda: conv(torch.empty(2, 8, 10, 10))) == \
            2 * 2 * 16 * 100 * 8 * 9
        # q, k, v, out projections and the two products of 4 heads of 8
        assert work._count(lambda: att(torch.empty(3, 50, 32))) == \
            4 * 2 * 3 * 50 * 32 * 32 + 4 * 3 * 50 * 50 * 32


def test_attention_calls_hand_count():
    cfg = manifest.load("serve-768-16f").config
    tr = dict(manifest.load("serve-768-16f").traffic)
    calls = work.serve_attention_calls(cfg, tr)
    T, steps, S0, S1 = 16, 20, 96 * 96, 48 * 48
    flops = sum(f * n for f, _, n in calls)
    self0 = 4 * 32 * S0 * S0 * 320 * 5 * steps + 4 * 16 * S0 * S0 * 320 * 5
    self1 = 4 * 32 * S1 * S1 * 640 * 5 * steps + 4 * 16 * S1 * S1 * 640 * 5
    cross = sum(4 * B * S * 257 * C * 5 * n for S, C in ((S0, 320), (S1, 640))
                for B, n in ((32, steps), (16, 1)))
    temporal = sum(4 * 2 * (96 >> lv) ** 2 * T * T * C * 2 * m * steps
                   for lv, (C, m) in enumerate(((320, 5), (640, 5), (1280, 5), (1280, 6))))
    vae = 4 * (20 + 16) * S0 * S0 * 512
    assert flops == self0 + self1 + cross + temporal + vae


def test_weights_are_seeded_and_fill_every_key():
    cfg = tiny_config("mikudance-sd15-video")
    a = run_weights(cfg, 7)
    b = run_weights(cfg, 7)
    c = run_weights(cfg, 8)
    assert all(torch.equal(a["den"][k], b["den"][k]) for k in a["den"])
    assert not torch.equal(a["den"]["conv_in.weight"], c["den"]["conv_in.weight"])
    w = a["guide"]["conv_in.weight"]
    assert w.abs().max() <= 1.0 / (20 * 9) ** 0.5 + 1e-6
    assert abs(float(a["vae"]["encoder.conv_norm_out.weight"].mean()) - 1.0) < 0.05


def run_weights(cfg, seed):
    from port_bench import weights

    return weights.make(cfg, ("vae", "guide", "den"), seed, CPU, torch.float32)


# ------------------------------------------------------- tiny cells on CPU
TINY_LIMITS = {"tiny-serve": {"frame_rmse": 0.5},
               "tiny-train": {"loss_gap": 1e-3, "grad_norm_gap": 1e-2, "change_norm_gap": 3e-2}}


def tiny_config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["dtype"] = "float32"
    cfg["unet"].update(block_out_channels=[32, 64, 96, 96], attention_heads=4)
    cfg["motion"]["num_attention_heads"] = 4
    cfg["vae"].update(block_out_channels=[16, 32, 32, 32], norm_num_groups=8)
    if "clip" in cfg:
        cfg["clip"].update(image_size=28, dim=64, inner=128, layers=2, heads=4)
    return cfg


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The benchmark copied, then tiny cells, a metric and a category added as
    new files and new BENCHMARK.json entries; no file that was there is
    edited."""
    root = tmp_path_factory.mktemp("bench")
    here = root / "port_bench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(here)
    bench = json.loads(json.dumps(BENCH))
    for cfg, tr, cell, changes in (
            ("mikudance-sd15-video", "clip-768-16f", "tiny-serve",
             dict(frames=3, height=128, width=128, steps=2, clip_tokens=5)),
            ("mikudance-sd15-stage2", "stage2-576-20f", "tiny-train",
             dict(frames=2, size=128, clip_size=28))):
        (here / "configs" / f"tiny-{cfg}.json").write_text(json.dumps(tiny_config(cfg)))
        traffic = json.loads((here / "traffic" / f"{tr}.json").read_text())
        traffic.update(changes)
        (here / "traffic" / f"tiny-{tr}.json").write_text(json.dumps(traffic))
        wl = json.loads((here / "workloads" / f"{'serve-768-16f' if 'serve' in cell else 'train-s2-576-20f'}.json").read_text())
        wl.update(limits=TINY_LIMITS[cell], warmup_steps=1)
        (here / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        bench["configs"].append({"name": f"tiny-{cfg}", "source": "tiny",
                                 "file": f"port_bench/configs/tiny-{cfg}.json",
                                 "reduced": [], "why": "CPU tests"})
        bench["workloads"].append({"name": cell, "config": f"tiny-{cfg}",
                                   "traffic": f"tiny-{tr}", "chips": 1, "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(("serve" in w) == ("serve" in cell)
                                        for w in m["workloads"]):
                m["workloads"].append(cell)
    (here / "metrics" / "window_requests.any.py").write_text(
        '"""Requests in the traced window."""\n\n\ndef read(rec):\n'
        '    return float(rec["requests"]) if rec.get("requests") else None\n')
    bench["per_layer"].append({"name": "window_requests.any", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "pipeline", "moves": "setup_s"})
    (here / "categories" / "zz_spin.json").write_text(json.dumps(
        {"order": 5, "group": "test", "patterns": ["spin_test_kernel"]}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(here)
    assert all(after[k] == v for k, v in before.items())
    return root


def tiny_cell(root: Path, name: str):
    return manifest.load(name, root, root / "port_bench")


def test_added_category_is_found_by_name(tiny_root):
    of = devtrace.Categoriser(devtrace.load_categories(tiny_root / "port_bench" / "categories"))
    assert of("void spin_test_kernel<1>()") == "zz_spin"


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_and_is_correct(tiny_root, cell, trace):
    c = tiny_cell(tiny_root, cell)
    out = run.run_cell(c, 2**31 + 11, 0.0, trace, CPU, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(TINY_LIMITS[cell])
    if trace:
        # CPU runs read no device metric; the added metric is read by name
        assert out["metrics"]["window_requests.any"]["value"] == 1.0
        assert not any(k.startswith(("mfu", "idle_share", "attn_roofline", "elementwise"))
                       for k in out["metrics"])
        assert out["device"]["busy_s"] == 0.0
    else:
        e2e = {m["name"] for m in c.end_to_end}
        assert set(out["metrics"]) == e2e
        assert e2e >= {"setup_s", "peak_gib"}


# ---------------------------------------------------- faults and controls
@pytest.mark.parametrize("fault", ["step_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train"])
def test_a_planted_fault_fails_the_check(tiny_root, monkeypatch, cell, fault):
    owner, attr, fn = faults.FAULTS["serve" if cell == "tiny-serve" else "train"]()[fault]
    monkeypatch.setattr(owner, attr, fn)
    out = run.run_cell(tiny_cell(tiny_root, cell), 2**31 + 12, 0.0, False, CPU,
                       time.perf_counter())
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train"])
def test_the_control_fails_a_limit_the_program_passes(tiny_root, cell):
    c = tiny_cell(tiny_root, cell)
    r = c.driver().readings(c, 13, CPU, control=True)
    lim = c.workload["limits"]
    assert all(r[k] <= lim[k] for k in lim), r
    assert any(r[f"control_{k}"] > lim[k] for k in lim), r


# ---------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_at_the_cells_size(card, cell):
    c = manifest.load(cell)
    r = c.driver().readings(c, 2**31 + 101, card, control=True)
    lim = c.workload["limits"]
    assert all(r[k] <= lim[k] for k in lim), r
    assert any(r[f"control_{k}"] > lim[k] for k in lim), r
