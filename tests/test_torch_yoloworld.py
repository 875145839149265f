"""YOLO-World-v2-L in the port (``litepi_tpu_torch/models/yoloworld.py``)
against the benchmark's plain float32 reference
(``cardbench/reference/yoloworld.py``), on the CPU, one torch thread; no
JAX package has this model.

Weights are ``cardbench.weights.make_states``'s (``raw_state`` draws,
BatchNorm calibrated on seeded frames, output layers scaled, class logits
centred per class) for the ``yoloworldv2l-shufflenetv2`` configuration at
a 128x128 input: every width and depth as published and LVIS's 1,203
classes, over 336 anchors.  Also: the max-sigmoid core, chunked and plain,
against Ultralytics' einsum written out here; a head's gating; the chunk
sizes at the cell's shapes; ``run_fused`` with the ``yoloworldv2l``
variant on letterboxed frames against the reference pipeline; the e2e CLI
with ``--detector_variant yoloworldv2l``; the new cell's files, its three
readers and its core counts; the class head's plain path off the card
(``kernels/vocab.py``).  The bf16 core and the class-head GEMM on the
card: ``tests/test_torch_yoloworld_cuda.py``.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from cardbench import judge, maxsig_counts, program, spec, traffic
from cardbench.metrics import _spans
from cardbench.metrics._empty_memsets import drop_empty_memsets
from cardbench.reference.two_stage import Reference, build_model
from cardbench.weights import make_states
from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.models import YoloWorldV2L
from litepi_tpu_torch.kernels.vocab import (
    takes_vocab_kernel,
    vocab_logits_cuda,
    vocab_logits_plain,
)
from litepi_tpu_torch.models.layers import flatten_anchors, runs_nchw, to_channels_last
from litepi_tpu_torch.models.yoloworld import (
    MAXSIG_TEMP_BYTES,
    MaxSigmoidAttn,
    max_sigmoid_attention,
    max_sigmoid_chunked,
    max_sigmoid_plain,
    maxsig_chunk,
    world_head,
)
from tests.test_torch_cardbench_spans import _lost_operation, make_run
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture, used by pytestmark)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CELL = "yoloworldv2l.card-b32-2048"
CONFIG = "yoloworldv2l-shufflenetv2"
SIZE = 128
NC = 1203
# float32 sums in other orders (the port's convs channels last or NCHW,
# the reference's NCHW; the guide products by einsum in chunks against one
# einsum) over the model's convs: measured 2.6e-6 of the largest logit at
# most; a bf16 step anywhere would move them by ~4e-3 of it
HEAD_RTOL = 2e-5


def small_config(dtype="float32"):
    cfg = spec.resolve(CELL).config
    return dict(cfg, detector=dict(cfg["detector"], input_size=SIZE),
                serving=dict(cfg["serving"], dtype=dtype))


@pytest.fixture(scope="module")
def states():
    return make_states(small_config(), 11, "cpu")


@pytest.mark.parametrize("layout", [torch.channels_last, torch.contiguous_format])
def test_yoloworldv2l_matches_the_reference_in_float32(states, layout):
    det, _ = states
    model = YoloWorldV2L(num_classes=NC).eval()
    model.load_state_dict(det)
    model.to(memory_format=layout)
    ref = build_model(small_config()["detector"]).eval()
    ref.load_state_dict(det)
    x = torch.rand((2, 3, SIZE, SIZE), generator=torch.Generator().manual_seed(3))
    reset_launch_counts()
    with torch.no_grad():
        got, want = model(x.contiguous(memory_format=layout)), ref(x)
    assert LAUNCHES["maxsig"] == 4
    assert got["reg"].shape == (2, 336, 64) and got["cls"].shape == (2, 336, NC)
    for k in ("reg", "cls"):
        assert got[k].dtype == torch.float32
        peak = float(want[k].abs().max())
        assert peak > 1.0  # logits of a few units: the calibrated head does work
        torch.testing.assert_close(got[k], want[k], atol=HEAD_RTOL * peak, rtol=0)
    # the class centring leaves no class winning everywhere
    assert want["cls"].argmax(-1).unique().numel() > 50


def _ultralytics(x, guide, bias, heads):
    """``MaxSigmoidAttnBlock.forward``'s weights as Ultralytics writes them
    (ec = c, so no ``ec`` conv), its ``gl(guide)`` the grouped conv's weight
    read as (bs, n, nh, hc), in float64."""
    bs, _, h, w = x.shape
    g = guide.double().reshape(heads, -1, 32).transpose(0, 1)  # (n, nh, hc)
    g = g[None].expand(bs, -1, -1, -1)
    embed = x.double().view(bs, heads, 32, h, w)
    aw = torch.einsum("bmchw,bnmc->bmhwn", embed, g)
    aw = aw.max(dim=-1)[0]
    aw = aw / (32 ** 0.5)
    aw = aw + bias.double()[None, :, None, None]
    return aw.sigmoid()


@pytest.mark.parametrize("chunk", [1, 64, 401, 500, NC, 2000])
def test_the_chunked_core_is_the_plain_core_and_ultralytics(chunk):
    gen = torch.Generator().manual_seed(chunk)
    x = (torch.randn((2, 128, 6, 5), generator=gen) * 3).contiguous(
        memory_format=torch.channels_last)
    guide = torch.randn((4 * NC, 32, 1, 1), generator=gen) / 32 ** 0.5
    bias = torch.randn((4,), generator=gen)
    want = _ultralytics(x, guide, bias, 4)
    plain = max_sigmoid_plain(x, guide, bias, 4)
    got = max_sigmoid_chunked(x, guide, bias, 4, chunk)
    assert got.shape == plain.shape == (2, 4, 6, 5) and got.dtype == torch.float32
    torch.testing.assert_close(plain.double(), want, atol=1e-6, rtol=0)
    torch.testing.assert_close(got.double(), want, atol=1e-6, rtol=0)
    # head-major: head 0's guides move only head 0's weights
    moved = guide.clone()
    moved[:NC] = -moved[:NC]
    got2 = max_sigmoid_chunked(x, moved, bias, 4, chunk)
    assert not torch.allclose(got2[:, 0], got[:, 0]) and torch.equal(got2[:, 1:], got[:, 1:])


def test_the_attention_gates_each_heads_channels_of_the_projection():
    torch.manual_seed(0)
    block = MaxSigmoidAttn(64, 5).eval()
    x = torch.randn((2, 64, 4, 3))
    with torch.no_grad():
        block.bias.copy_(torch.tensor([-1e4, 0.0]))  # head 0 shut, head 1 gated
        reset_launch_counts()
        y = block(x)
        assert LAUNCHES["maxsig"] == 1
        proj = block.proj(x)
        aw = max_sigmoid_plain(x, block.guide.weight, block.bias, 2)
    assert torch.equal(y[:, :32], torch.zeros_like(y[:, :32]))
    torch.testing.assert_close(y[:, 32:], proj[:, 32:] * aw[:, 1:2])
    assert float(aw[:, 1].min()) > 0.0 and float(aw[:, 1].max()) < 1.0


def test_the_cores_chunks_at_the_cells_shapes_stay_within_the_limit():
    calls = maxsig_counts.calls(spec.resolve(CELL).config["detector"], 32)
    want_pieces = {160: 4, 80: 2, 40: 1}
    for b, heads, h, w, nc, c in calls:
        x = torch.empty((b, c, h, w), dtype=torch.bfloat16, device="meta")
        chunk = maxsig_chunk(x, heads, nc)
        assert chunk * heads * b * h * w * 2 <= MAXSIG_TEMP_BYTES
        pieces = -(-nc // chunk)
        assert pieces == want_pieces[h]
        assert -(-nc // (chunk - 1)) > pieces  # spread evenly: no smaller chunk takes as few
    assert maxsig_chunk(torch.empty((1, 32, 1, 1)), 1, 10, limit=1) == 1


def test_the_core_runs_plain_off_the_card():
    x = torch.randn((1, 64, 3, 3))
    guide = torch.randn((2 * 7, 32, 1, 1))
    bias = torch.zeros(2)
    reset_launch_counts()
    assert torch.equal(max_sigmoid_attention(x, guide, bias, 2),
                       max_sigmoid_plain(x, guide, bias, 2))
    assert LAUNCHES["maxsig"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_world_head_keeps_the_plain_class_path_off_the_card(states, dtype):
    det, _ = states
    model = YoloWorldV2L(num_classes=NC).eval()
    model.load_state_dict(det)
    model.to(dtype=dtype, memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(5)
    feats = [torch.randn((2, c, s, s), generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last) for c, s in ((256, 4), (512, 2), (512, 1))]
    reset_launch_counts()
    with torch.no_grad():
        e = model.cls0_norm(model.cls0_embed(model.cls0_cv2(model.cls0_cv1(feats[0]))))
        assert not takes_vocab_kernel(e, model.cls0_out)
        got = world_head(model, feats)["cls"]
        # each level's biased class conv, flattened, copied into one float32 tensor
        want = torch.cat([flatten_anchors(getattr(model, f"cls{i}_out")(getattr(
            model, f"cls{i}_norm")(getattr(model, f"cls{i}_embed")(getattr(
                model, f"cls{i}_cv2")(getattr(model, f"cls{i}_cv1")(f))))))
            for i, f in enumerate(feats)], dim=1).float()
    assert LAUNCHES["vocab_gemm"] == 0
    assert got.dtype == torch.float32 and got.shape == (2, 16 + 4 + 1, NC)
    assert torch.equal(got, want)


def test_the_plain_class_logits_write_their_rows_only_and_the_kernel_wants_the_card():
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 64, 3, 5), generator=gen).bfloat16().contiguous(
        memory_format=torch.channels_last)
    weight = torch.randn((7, 64, 1, 1), generator=gen).bfloat16()
    bias = torch.randn(7, generator=gen).bfloat16()
    out = torch.full((2, 15 + 6, 7), float("nan"))
    vocab_logits_plain(x, weight, bias, out, 4)
    want = torch.nn.functional.conv2d(x, weight, bias).float().permute(0, 2, 3, 1).reshape(2, 15, 7)
    assert torch.equal(out[:, 4:19], want)
    assert out[:, :4].isnan().all() and out[:, 19:].isnan().all()
    with pytest.raises(ValueError, match="CUDA"):
        vocab_logits_cuda(x, weight, bias, out, 4)


def test_state_dict_is_the_references_and_channels_last_needs_no_special_case():
    cfg = dict(small_config()["detector"], num_classes=80)
    with torch.device("meta"):
        ref, port = build_model(cfg), YoloWorldV2L(num_classes=80)
    assert {k: v.shape for k, v in ref.state_dict().items()} == {
        k: v.shape for k, v in port.state_dict().items()}
    sd = port.state_dict()
    assert sd["c2fattn_p4a.attn.guide.weight"].shape == (8 * 80, 32, 1, 1)
    assert sd["c2fattn_p3.attn.guide.weight"].shape == (4 * 80, 32, 1, 1)
    assert sd["c2fattn_p5.cv2.conv.weight"].shape == (512, 6 * 256, 1, 1)
    assert sd["cls0_out.weight"].shape == (80, 512, 1, 1) and "cls0_out.bias" in sd
    assert not any(runs_nchw(m) for m in port.modules())
    to_channels_last(port)
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for p in port.parameters() if p.dim() == 4)


def test_run_fused_with_yoloworldv2l_matches_the_reference_pipeline(states):
    det, cls = states
    cfg = small_config()
    frames = traffic.make_frames(11, 0, 2, 200, 200, "cpu")
    run_fused = program.build(cfg, det, cls, 2, "cpu")
    reset_launch_counts()
    got = run_fused(frames)
    assert LAUNCHES["maxsig"] == 4
    ref = Reference(cfg, det, cls, "cpu")
    want = ref.run_pipeline(frames)
    v = want["valid"]
    assert torch.equal(got["valid"], v) and bool(v.any())
    assert torch.equal(got["det_class_ids"][v], want["det_class_ids"][v])
    assert got["det_class_ids"][v].unique().numel() > 1  # a vocabulary at work
    assert torch.allclose(got["boxes"][v], want["boxes"][v], atol=1e-3)
    assert torch.allclose(got["det_scores"], want["det_scores"], atol=1e-5)
    assert torch.allclose(got["cls_probs"][v], want["cls_probs"][v], atol=1e-5)
    assert torch.equal(got["cls_labels"][v], want["cls_labels"][v])
    numbers = judge.gaps(ref, [(frames, got)])
    assert numbers["box"] < 1e-3 and numbers["score"] < 1e-4 and numbers["choice"] < 1e-3


def test_e2e_cli_runs_yoloworldv2l(tmp_path):
    from litepi_tpu_torch.apps import e2e

    images, labels, out = (str(tmp_path / k) for k in ("images", "labels", "out"))
    os.makedirs(images), os.makedirs(labels)
    rng = np.random.default_rng(0)
    for i in range(2):
        cv2.imwrite(os.path.join(images, f"img{i}.jpg"),
                    rng.integers(0, 256, (160, 200, 3), dtype=np.uint8))
    with open(os.path.join(labels, "img0.txt"), "w") as f:
        f.write("3 0.5 0.5 0.2 0.2\n")
    common = ["--input", images, "--labels", labels, "--output", out, "--device", "cpu",
              "--detector_variant", "yoloworldv2l", "--det_input_size", "64",
              "--batch_size", "2", "--max_det", "8", "--max_candidates", "64",
              "--num_samples", "2", "--warmup", "0"]
    assert e2e.main(common) == 0
    assert os.path.isfile(os.path.join(out, "comparison_summary.csv"))
    assert e2e.main(common + ["--detector", "best.pt"]) == 2


def _with_c2fattn(k, rows):
    """Batch k's rows with a C2fAttn inside the detect span (a memset of no
    bytes and a conv, then under litepi.maxsig a GEMM, a max and a
    sigmoid), and the class head's vocabulary-wide part under litepi.vocab
    (a conv and a copy)."""
    i = next(j for j, r in enumerate(rows) if r[0] == "litepi.detect")
    return rows[:i + 1] + [
        ("litepi.c2fattn", (480, 790), [("cudaMemsetAsync", 482, 484, "", 0),
                                        ("cudaLaunchKernel", 485, 490, "sm90_xmma_fprop", 40)]),
        ("litepi.maxsig", (600, 700), [
            ("cudaLaunchKernel", 610, 615, "nvjet_hsh_bf16_gemm", 60),
            ("cudaLaunchKernel", 620, 625, "reduce_kernel_max", 30),
            ("cudaLaunchKernel", 630, 635, "vectorized_elementwise_kernel_sigmoid", 10)]),
        ("litepi.vocab", (800, 890), [
            ("cudaLaunchKernel", 810, 815, "sm90_xmma_fprop_1203", 70),
            ("cudaLaunchKernel", 820, 825, "elementwise_kernel_copy", 25)]),
    ] + rows[i + 1:]


def test_the_cell_resolves_and_its_readers_read_the_new_spans():
    cell = spec.resolve(CELL)
    det = cell.config["detector"]
    assert cell.chips == 1 and det["variant"] == "yoloworldv2l" and det["reference"] == "yoloworld"
    assert cell.config["reduced"] == [] and det["input_size"] == 1280 and det["num_classes"] == NC
    assert cell.traffic == json.loads((spec.HERE / "traffic" / "card-b32-2048.json").read_text())
    assert [m["name"] for m in cell.per_layer] == [
        "c2fattn_ms.batch", "maxsig_roofline", "vocab_ms.batch"]
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}
    bound = maxsig_counts.bound_s(CONFIG, 32)
    for batches in (1, 3):
        run = dict(make_run(batches, edit=_with_c2fattn), batch=32)
        run["device"] = [d for d in run["device"] if d[0]]  # the empty memset's
        assert _spans.pair(run) is None and _spans.pair(drop_empty_memsets(run)) is not None
        assert spec.reader("c2fattn_ms.batch")(run) == pytest.approx((40 + 60 + 30 + 10) / 1e3)
        assert spec.reader("vocab_ms.batch")(run) == pytest.approx((70 + 25) / 1e3)
        assert spec.reader("maxsig_roofline")(run) == pytest.approx(100 * bound / 100e-6)
    # a kernel whose operation the trace lacks still refuses the pairing
    lost = dict(make_run(2, edit=lambda k, rows: _lost_operation(k, _with_c2fattn(k, rows))),
                batch=32)
    lost["device"] = [d for d in lost["device"] if d[0]]
    plain = dict(make_run(2), batch=32)  # paired, but no YOLO-World spans: another model's
    for name in ("c2fattn_ms.batch", "maxsig_roofline", "vocab_ms.batch"):
        assert spec.reader(name)(plain) is None and spec.reader(name)(lost) is None
        assert spec.reader(name)({"frames_per_s": 1.0}) is None


def test_max_sigmoid_counts_of_the_cell():
    calls = maxsig_counts.calls(spec.resolve(CELL).config["detector"], 32)
    # the 4 C2fAttn in call order: P4 (top-down), P3, P4 (bottom-up), P5
    assert calls == [(32, 8, 80, 80, NC, 256), (32, 4, 160, 160, NC, 128),
                     (32, 8, 80, 80, NC, 256), (32, 8, 40, 40, NC, 256)]
    ops = sum(maxsig_counts.counts(*c)[0] for c in calls)
    assert ops == 2 * 32 * NC * (160 ** 2 * 128 + 2 * 80 ** 2 * 256 + 40 ** 2 * 256)
    assert ops / 1e9 == pytest.approx(536.11, abs=0.01)
    ops0, bytes0 = maxsig_counts.counts(*calls[1])
    assert bytes0 == 2 * (32 * 128 * 160 * 160 + 4 * NC * 32 + 32 * 4 * 160 * 160)
    assert maxsig_counts.bound_s(CONFIG, 32) == pytest.approx(ops / 989e12)  # FLOP-bound
