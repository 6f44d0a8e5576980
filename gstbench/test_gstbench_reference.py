"""The benchmark's reference against the port's plain path, on the CPU
at tiny sizes, and the controls a lower precision must fail."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from gstbench import docs as D
from gstbench import flops, harness as H, testing as T, weights as W
from gstbench.reference import gst as R
from gstbench.reference import precision as P


@pytest.mark.parametrize("workload", T.CELLS)
def test_a_sound_run_is_correct(workload):
    r = T.execute(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("heads,kv,want", [(16, 8, (4, 2)), (16, 16, (4, 4)),
                                           (28, 4, (7, 1))])
def test_tiny_sizes_come_from_the_files(heads, kv, want):
    gst = {"segments": 8, "classes": 16}
    tiny = T.tiny_of({"num_attention_heads": heads,
                      "num_key_value_heads": kv, "gst": gst})
    assert (tiny["num_attention_heads"], tiny["num_key_value_heads"]) == want
    assert tiny["hidden_size"] == want[0] * tiny["head_dim"]
    for path in (H.HERE / "traffic").glob("*.json"):
        assert set(T.tiny_traffic(path.stem)) <= set(H.load_json(path))


@pytest.mark.parametrize("config", T.CONFIGS)
def test_weights_match_the_port_layout(config):
    from repro_torch.models import transformer
    from repro_torch.models.common import flatten_tree
    cfg_file = {**H.load_json(H.HERE / "configs" / f"{config}.json"),
                "name": config, **T.tiny_config(config)}
    arch = H.arch_of(cfg_file)
    cfg = H.port_config(arch, cfg_file["gst"])
    port = dict(flatten_tree(transformer.init_params(
        torch.Generator().manual_seed(0), cfg)))
    ours = dict(flatten_tree(W.backbone(arch, 5, "cpu")))
    assert list(port) == list(ours)
    for k in port:
        assert port[k].shape == ours[k].shape, k
    again = W.backbone_leaf(arch, 5, "runs.0.mlp.w_in", "cpu")
    assert torch.equal(again, ours["runs.0.mlp.w_in"])


@pytest.mark.parametrize("config", T.CONFIGS)
def test_reference_logits_match_the_port(config):
    from repro_torch.core import gst as G
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten_tree
    cfg_file = {**H.load_json(H.HERE / "configs" / f"{config}.json"),
                "name": config, **T.tiny_config(config)}
    arch = H.arch_of(cfg_file)
    model = build_model(H.port_config(arch, cfg_file["gst"]),
                        use_kernels=False, device="cpu")
    w = W.backbone(arch, 11, "cpu")
    hd = W.head(arch, 16, 11, "cpu")
    tokens = torch.randint(0, arch["vocab_size"], (3, 16),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        h, _ = model.encode_segment(w, {"tokens": tokens})
        v = torch.ones(1, 3)
        pooled = ops.sed_aggregate(h[None], v, v, torch.zeros_like(v),
                                   keep_prob=1.0, num_sampled=1,
                                   use_kernels=False)
        head = G.Head(arch["d_model"], 16, "mlp", torch.Generator())
        for k, t in hd.items():
            getattr(head, k).copy_(t)
        port = G.head_apply(head, pooled, "mlp")[0]
    ref = R.predict(dict(flatten_tree(w)), hd, arch, tokens)
    assert float((port - ref).abs().max() / ref.abs().max()) < 1e-5


def _train_readings(mode):
    from gstbench.paths import train_efd as TE
    config, traffic = T.cell_files("internlm2-1.8b.train_efd")
    cfg = {**H.load_json(H.HERE / "configs" / f"{config}.json"),
           "name": config, **T.tiny_config(config)}
    cell = H.Cell("internlm2-1.8b.train_efd", cfg, H.arch_of(cfg),
                  {**H.load_json(H.HERE / "traffic" / f"{traffic}.json"),
                   **T.tiny_traffic(traffic)}, 99, 0.1, False, "cpu",
                  0.0)
    return cell, TE.reference(cell, mode)


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
def test_lower_precision_controls_fail_the_train_check(mode):
    from gstbench.paths import train_efd as TE
    cell, exact = _train_readings("f32")
    _, low = _train_readings(mode)
    limits = H.load_json(H.HERE / "limits"
                         / "internlm2-1.8b.train_efd.json")["limits"]
    got = TE.numbers(low, exact)
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
def test_lower_precision_controls_fail_the_predict_check(mode):
    from gstbench.paths import predict as PR
    cfg = {**H.load_json(H.HERE / "configs" / "internlm2-1.8b.json"),
           "name": "internlm2-1.8b", **T.tiny_config("internlm2-1.8b")}
    cell = H.Cell("internlm2-1.8b.predict", cfg, H.arch_of(cfg),
                  {**H.load_json(H.HERE / "traffic" / "predict.json"),
                   **T.tiny_traffic("predict")}, 99, 0.1, False, "cpu",
                  0.0)
    reqs = [(0, 4), (1, 1), (2, 3)]
    gap = PR.logit_gap(PR.reference(cell, reqs, mode),
                       PR.reference(cell, reqs, "f32"))
    limit = H.load_json(H.HERE / "limits" / "internlm2-1.8b.predict.json")[
        "limits"]["logits"]
    assert gap > limit


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -3.0])
    got = P.round_tf32(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10, -3.0]


def test_docs_follow_the_topic_law():
    d = D.property_docs(64, 8, 32, 1000, 5, 0.8, seed=3, tag=1)
    assert d["tokens"].shape == (64, 8, 32)
    assert d["tokens"].min() >= 0 and d["tokens"].max() < 1000
    again = D.property_docs(64, 8, 32, 1000, 5, 0.8, seed=3, tag=1)
    assert np.array_equal(d["tokens"], again["tokens"])
    band = (d["tokens"] * 5) // 1000
    # each segment's mode band is its topic; the label the majority topic
    seg_band = np.array([[np.bincount(s, minlength=5).argmax() for s in doc]
                         for doc in band])
    counts = np.array([np.bincount(t, minlength=5) for t in seg_band])
    assert np.array_equal(counts.argmax(1), d["labels"])


def test_every_seed_sends_the_same_segment_counts():
    a = D.request_segments(16, 64, 128, seed=1, tag=6)
    b = D.request_segments(16, 64, 128, seed=2, tag=6)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert a.min() == 1 and a.max() == 16
    assert math.isclose(D.segment_cycle(16, 32).mean(), 5.1875)


def test_flop_counts():
    cfg = {**H.load_json(H.HERE / "configs" / "internlm2-1.8b.json"),
           "name": "internlm2-1.8b"}
    arch = H.arch_of(cfg)
    assert flops.matmul_params(arch) == 24 * 62_914_560
    step = flops.train_step_flops(arch, 8, 1, 512, 16)
    assert step == 3 * (2 * 24 * 62_914_560 * 4096
                        + 24 * 4 * 8 * 16 * 128 * (512 * 513 // 2)
                        + 2 * 8 * (2048 * 2048 + 2048 * 16))
    peaks = H.load_json(H.HERE / "peaks.json")["NVIDIA H100 80GB HBM3"]
    # B6 at 5 segments of 512 is bound by its bytes
    assert flops.swa_bound_s(arch, 5, 512, peaks) == pytest.approx(
        4 * (2 * 5 * 512 * 16 * 128 + 2 * 5 * 512 * 8 * 128) / 3.35e12)


def test_metric_readers_on_a_record():
    bench = T.bench()
    rec = {"kind": "train", "units": 2, "flops": 4.95e12, "host_s": [0.01],
           "peaks": {"tf32_flops": 495e12, "hbm_bytes_per_s": 3.35e12},
           "trace": {"window_s": 1.0, "busy_s": 0.75,
                     "device_s": {"sm90_xmma_gemm_f32": 0.5,
                                  "vectorized_elementwise_kernel": 0.25}}}
    want = {"train.mfu": 1.0, "train.gemm_ms": 250.0,
            "train.nongemm_ms": 125.0, "train.host_ms": 10.0,
            "train.idle_share": 25.0}
    for m in bench["per_layer"]:
        reader = H.load_module(H.HERE / "metrics" / f"{m['name']}.py",
                               f"reader_{m['name']}")
        got = reader.read(rec)
        if m["name"].startswith("train."):
            assert got == pytest.approx(want[m["name"]]), m["name"]
        else:
            assert got is None, m["name"]
    rec = {**rec, "kind": "predict", "swa_bound_s": 0.01,
           "trace": {**rec["trace"], "device_s": {
               "swa_attention_kernel": 0.04, "sm90_xmma_gemm": 0.5}}}
    reader = H.load_module(H.HERE / "metrics" / "predict.swa_roofline.py",
                           "reader_swa")
    assert reader.read(rec) == pytest.approx(25.0)
