"""Where a word of K1's cluster greedy pass spends its time on the card.

    python -m litepi_tpu_torch.tools.nms_trace

Builds a copy of ``csrc/nms.cu`` with ``clock64`` / ``%globaltimer``
probes in ``nms_greedy_cluster_kernel`` (inserted at fixed lines of the
source; the tool raises when the source no longer has them), runs it on
``tools/nms_ab.py``'s inputs (seed 0, 1 class) at B = 8, K = 8,400 and
2,000, and prints one JSON line per case for image 0's cluster (16
blocks):

* for each word w + 1, on the block that decides it, the SM cycles spent
  waiting for word w's keep word, ORing w into column w + 1 (the slot's
  barrier, the loads, two ``__reduce_or_sync``), getting the diagonal
  segment, ``greedy_word``, and publishing (medians over the words);
* the chain's period, the global time between consecutive deciders
  receiving their keep words, and the time from a publication to its
  receipt by the next decider (nanoseconds, ``%globaltimer``);
* each block's ORs of its later columns per word (SM cycles, by the
  number of columns).

The probes are global stores on the chain and slow it (a word takes
~1.15 us traced at (8, 8,400), ~1.0 us untraced): the pass's device time
is ``tools/nms_ab.py``'s to give.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from litepi_tpu_torch.kernels import build as kbuild
from litepi_tpu_torch.tools.nms_ab import build_other, caller, nms_inputs

CASES = ((8, 8400), (8, 2000))  # (B, K): 16-block clusters, at most WORDS words
WORDS = 160
BLOCKS = 16
SLOTS = 8  # probes per (block, word)

# (line of csrc/nms.cu, text inserted after it)
PROBES = (
    ("#include <mutex>\n",
     "__device__ unsigned long long g_trace[%d];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n"
     "extern \"C\" int litepi_nms_trace(void* host, int n) {\n"
     "  return cudaMemcpyFromSymbol(host, g_trace, (size_t)n * 8);\n"
     "}\n" % (2 * BLOCKS * WORDS * SLOTS)),
    ("      const u64 kept = greedy_word(ring + 64 * s, r);\n",
     "      if (tr) { T[c * 8 + 4] = clock64() + (kept & 1ull) * 0; }\n"),
    ("                lane);\n",
     "      if (tr) { T[c * 8 + 5] = clock64(); T[c * 8 + 6] = gtime(); }\n"),
    ("      if (lane == 0) mbar_expect_tx(smem_u32(kept_bar + ks), sizeof(u64));\n"
     "      mbar_wait<true>(smem_u32(kept_bar + ks), (w / kKeptSlots) & 1);\n",
     "      if (tr) { T[w * 8 + 1] = clock64(); T[w * 8 + 7] = gtime(); }\n"),
    ("        const u64 r = removed[c / n] | (kept ? kept_rows_or(ring + 64 * s, k0, k1) : 0ull);\n",
     "        if (tr) { T[w * 8 + 2] = clock64() + (r & 1ull) * 0; }\n"),
)
# (line, text inserted before it)
BEFORE = (
    ("    auto decide = [&](int c, u64 r) {  // word c, its removed set r\n",
     "    const bool tr = blockIdx.x < n && W <= %d && lane == 0;\n"
     "    unsigned long long* T = g_trace + rank * %d * 8;\n"
     "    unsigned long long* G = g_trace + (%d + rank) * %d * 8;\n"
     % (WORDS, WORDS, BLOCKS, WORDS)),
    ("      const u64 kept = greedy_word(ring + 64 * s, r);\n",
     "      if (tr) { T[c * 8 + 3] = clock64(); }\n"),
    ("      if (lane == 0) mbar_expect_tx(smem_u32(kept_bar + ks), sizeof(u64));\n",
     "      if (tr) { T[w * 8 + 0] = clock64(); }\n"),
    ("      for (; c < words; c += kGroup * n) {\n",
     "      if (tr) { G[w * 8 + 0] = clock64(); G[w * 8 + 2] = c < words ? (words - c + n - 1) / n : 0; }\n"),
    ("    }\n  }\n  cluster_sync();  // no block leaves while a block of its cluster may still signal it\n",
     "      if (tr) { G[w * 8 + 1] = clock64(); }\n"),
)


def instrumented_source() -> str:
    src = (kbuild.CSRC / "nms.cu").read_text()
    for line, text in BEFORE:
        if src.count(line) != 1:
            raise RuntimeError(f"nms_trace: csrc/nms.cu no longer has the line {line!r}")
        src = src.replace(line, text + line)
    for line, text in PROBES:
        if src.count(line) != 1:
            raise RuntimeError(f"nms_trace: csrc/nms.cu no longer has the line {line!r}")
        src = src.replace(line, line + text)
    return src


def trace(dev, b: int, k: int, lib, call) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    boxes, cls, valid = nms_inputs(gen, b, k, 1, dev)
    for _ in range(3):
        call(boxes, cls, valid)
    torch.cuda.synchronize()
    n = 2 * BLOCKS * WORDS * SLOTS
    buf = (ctypes.c_ulonglong * n)()
    kbuild.check(lib.litepi_nms_trace(ctypes.addressof(buf), n), "nms_trace copy")
    t = np.frombuffer(buf, dtype=np.uint64).astype(np.int64).reshape(2, BLOCKS, WORDS, SLOTS)
    T, G = t[0], t[1]
    words = int(valid[0].nonzero().max().item()) // 64 + 1
    blocks = 16
    rows = []
    for w in range(words - 2):
        o, o2 = (w + 1) % blocks, (w + 2) % blocks  # the deciders of w + 1 and w + 2
        p, d = T[o, w], T[o, w + 1]
        rows.append(dict(wait=p[1] - p[0], or_next=p[2] - p[1], diagonal=d[3] - p[2],
                         greedy_word=d[4] - d[3], publish=d[5] - d[4],
                         to_next_receipt_ns=T[o2, w + 1, 7] - d[6],
                         period_ns=T[o2, w + 1, 7] - p[7]))
    background = {}
    for r in range(blocks):
        for w in range(words - 1):
            if G[r, w, 2] > 0:
                background.setdefault(int(G[r, w, 2]), []).append(int(G[r, w, 1] - G[r, w, 0]))
    return {
        "shape": f"B={b} K={k}, 1 class", "words_image0": words, "cluster_blocks": blocks,
        "decider_median_cycles": {key: float(np.median([r[key] for r in rows]))
                                  for key in ("wait", "or_next", "diagonal", "greedy_word",
                                              "publish")},
        "chain_period_ns_median": float(np.median([r["period_ns"] for r in rows])),
        "publication_to_next_receipt_ns_median":
            float(np.median([r["to_next_receipt_ns"] for r in rows])),
        "later_columns_cycles_by_count": {c: [len(v), float(np.median(v))]
                                          for c, v in sorted(background.items())},
    }


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("nms_trace: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    path = kbuild.BUILD_DIR / "nms_trace.cu"
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(instrumented_source())
    lib = build_other(path)
    lib.litepi_nms_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.litepi_nms_trace.restype = ctypes.c_int
    call = caller(lib)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    for b, k in CASES:
        print(json.dumps({"device": smi, **trace(dev, b, k, lib, call)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
