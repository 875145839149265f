"""The benchmark's stage readers (``cardbench/metrics/_spans.py`` and the
five readers on it) on hand-made host and device intervals: pairing from
the end, each stage's device time, the checks that refuse a pairing, the
host's dispatch time and the launches per batch."""

import pytest

from cardbench import spec
from cardbench.metrics import _spans

READERS = ("detect_ms.batch", "post_ms.batch", "classify_ms.batch",
           "host_dispatch_ms.batch", "launches.batch")
US = 1000  # ns

# one batch: (stage span, its (start, end) in us from the root's start, the
# submission calls under it as (name, start, end, device op, op us))
BATCH = (
    ("stem", (100, 400), [("cudaLaunchKernel", 150, 160, "stem_tiled_kernel", 100)]),
    ("detect", (400, 900), [("cudaLaunchKernel", 450, 470, "sm90_xmma_fprop", 200)]),
    ("candidates", (900, 1000), [("cudaLaunchKernel", 910, 920, "radixSortKernel", 10)]),
    ("suppress", (1000, 1100), [("cudaLaunchKernelExC_v11060", 1010, 1020, "nms_small_kernel", 20)]),
    ("unmap", (1100, 1200), [("cudaLaunchKernel", 1110, 1120, "elementwise_kernel", 5)]),
    ("crop", (1200, 1300), [("cudaLaunchKernel", 1210, 1220, "roi_crop_kernel", 7)]),
    ("classify", (1300, 1900), [("cudaLaunchKernel", 1310, 1320, "shufflenet_gemm", 50),
                                ("cudaMemsetAsync", 1400, 1410, "Memset (Device)", 3)]),
)
READBACK = ("cardbench.readback", (2100, 2300),
            [("cudaMemcpyAsync", 2150, 2160, "Memcpy DtoH (Device -> Pinned)", 4)])
ROOT_US = 2000
PERIOD_US = 4000


def make_run(batches=2, leftovers=True, edit=None):
    """A traced tail of ``batches`` batches.  Batch 0's root starts at 1 ms;
    each call's device operation starts 300 us after the call, or when the
    stream is free.  ``leftovers`` puts two operations of batches launched
    before the tail at its start; ``edit(k, rows)`` may change batch k's
    rows."""
    host, device = [], []
    free = 0
    if leftovers:
        device += [("old_kernel", 5 * US, 900 * US), ("Memcpy DtoH (Device -> Pinned)", 900 * US, 950 * US)]
        free = 950 * US
    for k in range(batches):
        t = (1000 + PERIOD_US * k) * US
        host.append(("litepi.run_fused", t, t + ROOT_US * US))
        # the completion thread's wait, overlapping the call
        host.append(("cudaEventSynchronize", t + 500 * US, t + 1500 * US))
        host.append(("cardbench.issue", t - 10 * US, t + (ROOT_US + 10) * US))
        rows = [("litepi." + stage, lim, calls) for stage, lim, calls in BATCH] + [READBACK]
        if edit is not None:
            rows = edit(k, rows)
        for name, (s, e), calls in rows:
            host.append((name, t + s * US, t + e * US))
            for call, cs, ce, op, dur in calls:
                if call is None:  # an operation whose call the trace lacks
                    call = ""
                host.append((call, t + cs * US, t + ce * US))
                host.append(("aten::empty", t + cs * US - 5 * US, t + cs * US - 1 * US))
                start = max(t + (cs + 300) * US, free)
                free = start + dur * US
                device.append((op, start, free))
    hi = (1000 + PERIOD_US * batches) * US
    host.append(("cardbench.window", 0, hi))
    return {"window_ns": (0, hi), "host": host, "device": device, "batches_traced": batches}


def read(name, run):
    return spec.reader(name)(run)


def test_pairing_from_the_end_drops_the_earlier_batches_operations():
    tail = _spans.pair(make_run())
    assert len(tail.calls) == len(tail.ops) == 2 * 9
    assert tail.ops[0][0] == "stem_tiled_kernel"
    assert [c.span for c in tail.calls[:9]] == [
        "litepi.stem", "litepi.detect", "litepi.candidates", "litepi.suppress", "litepi.unmap",
        "litepi.crop", "litepi.classify", "litepi.classify", "cardbench.readback"]
    assert {c.batch for c in tail.calls} == {0, 1}


@pytest.mark.parametrize("name, want_us", [("detect_ms.batch", 100 + 200),
                                           ("post_ms.batch", 10 + 20 + 5 + 7),
                                           ("classify_ms.batch", 50 + 3)])
@pytest.mark.parametrize("batches", [1, 3])
def test_a_stages_device_ms_is_its_paired_operations_over_the_batches(name, want_us, batches):
    assert read(name, make_run(batches)) == pytest.approx(want_us / 1e3)


def _kind_mismatch(k, rows):
    stage, lim, calls = rows[4]  # in every batch, a launch whose operation reads as a copy
    rows[4] = (stage, lim, [calls[0][:3] + ("Memcpy DtoD (Device -> Device)", 5)])
    return rows


def _extra_call(k, rows):
    if k == 1:  # one batch makes one call more
        stage, lim, calls = rows[4]
        rows[4] = (stage, lim, calls + [("cudaLaunchKernel", 1150, 1160, "elementwise_kernel", 5)])
    return rows


def _lost_operation(k, rows):
    if k == 1:  # a call whose operation the trace lacks
        stage, lim, calls = rows[2]
        rows[2] = (stage, lim, [calls[0][:3] + ("", 0)])
    return rows


def _untraced_call(k, rows):
    if k == 1:  # an operation whose call the trace lacks
        stage, lim, calls = rows[5]
        rows[5] = (stage, lim, calls + [(None, 1230, 1240, "elementwise_kernel", 5)])
    return rows


def _other_names(k, rows):
    if k == 1:  # the batches run different kernels
        stage, lim, calls = rows[1]
        rows[1] = (stage, lim, [calls[0][:3] + ("sm80_xmma_fprop", 200)])
    return rows


def _no_spans(run):
    run["host"] = [h for h in run["host"] if not h[0].startswith("litepi.")]
    return run


def _drop_empty(run):
    run["device"] = [d for d in run["device"] if d[0]]
    return run


CASES = {
    "kind": lambda: make_run(edit=_kind_mismatch),
    "unequal_calls": lambda: make_run(edit=_extra_call),
    "lost_operation": lambda: _drop_empty(make_run(edit=_lost_operation)),
    "no_program_spans": lambda: _no_spans(make_run()),
    "too_few_operations": lambda: _drop_empty(make_run(leftovers=False, edit=_lost_operation)),
    "untraced_call": lambda: make_run(edit=_untraced_call),
    "other_names": lambda: make_run(edit=_other_names),
    "roots_not_batches": lambda: dict(make_run(), batches_traced=3),
    "untraced": lambda: {"frames_per_s": 1.0},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", READERS)
def test_a_pairing_that_does_not_hold_gives_none(case, name):
    assert read(name, CASES[case]()) is None


def test_pairing_is_by_order_not_by_the_two_clocks():
    # the device's clock 303 us behind the host's: the first operation,
    # launched onto an idle card, reads as starting before its call
    run = make_run(leftovers=False)
    run["device"] = [(n, s - 303 * US, e - 303 * US) for n, s, e in run["device"]]
    assert run["device"][0][1] < (1000 + 150) * US
    tail = _spans.pair(run)
    assert tail is not None and tail.ops[0][0] == "stem_tiled_kernel"
    assert read("detect_ms.batch", run) == pytest.approx(0.3)


def test_host_dispatch_subtracts_only_the_submission_calls_nested_in_the_root():
    # 2,000 us of root less its 8 calls of 10-20 us; the overlapping
    # cudaEventSynchronize takes nothing off
    nested = 10 + 20 + 10 + 10 + 10 + 10 + 10 + 10
    assert read("host_dispatch_ms.batch", make_run()) == pytest.approx((ROOT_US - nested) / 1e3)


def test_launches_count_the_calls_under_the_root_only():
    # 8 under litepi.run_fused; the readback's copy is under cardbench.readback
    assert read("launches.batch", make_run(3)) == 8.0


def test_submission_names_with_cuptis_suffixes():
    assert _spans.submit_kind("cudaLaunchKernelExC_v11060") == "kernel"
    assert _spans.submit_kind("cudaMemcpyAsync_ptsz") == "memcpy"
    assert _spans.submit_kind("cudaEventSynchronize") is None
    assert _spans.op_kind("Memset (Device)") == "memset"
