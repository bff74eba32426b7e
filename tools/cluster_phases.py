"""Where the cluster flush kernel's time goes, phase by phase, on one CUDA card.

    PYTHONPATH=src python tools/cluster_phases.py

Copies ``src/repro_torch/csrc/ss_ingest.cu`` into ``build/phases/``, inserts
``clock64()`` marks at the phase boundaries of ``fused_ingest_cluster_kernel``
(recorded by thread 0 of the grid's first and last block), builds the copy
with the port's ``nvcc`` flags and drives it through the port's wrapper, so
the kernel measured is the one the wrapper launches. The marks cost a few
stores a phase; every output is still held bit for bit against the plain
version. Also times ``cluster.sync()`` alone (1 000 in a loop, one cluster of
C blocks of 1 024 threads) at each C. Prints one JSON line a case and block
(SM cycles of each phase: the loads, min_frequency, the window sort, the
run starts, the match, the select's count-and-OR exchange, its radix
passes, the compaction, the winners' sort, the output and the final sync;
and the pieces of the window sort's first pass), then the card's name and
power limit. The source itself is not changed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build, ref, ss_ingest

PHASES = ("load", "min_frequency", "window_sort", "run_starts", "match", "select_prepass",
          "select", "compaction", "winners_sort", "output")
DEFAULT_CASES = ("64,2048,65536,4", "64,8000,16384,2", "2,16384,131072,16")

# (anchor in the source, text to insert, after the anchor?, which occurrence)
MARKS = (
    ("  const int64_t id0 = b * w + static_cast<int64_t>(r) * S;\n", "  PH(0);\n", True, 1),
    ("  const T m1 = cluster_min_frequency(cl, items, counts, nk);", "  PH(1);\n", False, 1),
    ("  cluster_radix_sort<uint32_t>(cl, IdKey{}, ids, pos, w, S, count);", "  PH(2);\n",
     False, 1),
    ("  // run starts: position q starts a run", "  PH(3);\n", False, 1),
    ("  // match + offsets (m2 = 0, no candidate errors): an EMPTY slot becomes", "  PH(4);\n",
     False, 1),
    ("  cluster_keep_top_k<T>(cl, IngestClusterPool", "  PH(5);\n", False, 1),
    ("  const bool take_all = n_valid <= static_cast<unsigned long long>(k);", "  PH(6);\n",
     False, 1),
    ("  const T thr = take_all ? T(-1) : static_cast<T>(prefix);\n  const unsigned ties",
     "  PH(7);\n", False, 1),
    ("  cluster_radix_sort<U>(cl, WinnerOrder<T>{}, win0", "  PH(8);\n", False, 1),
    ("  const int first = cl.rank * ks;", "  PH(9);\n", False, 1),
    ("  cl.sync();   // no block leaves while", "  PH(10);\n", False, 1),
    ("  cl.sync();   // no block leaves while a peer may read its shared memory\n", "  PH(17);\n",
     True, 1),
    # the window sort's first pass (4-byte records only)
    ("    reinterpret_cast<uint4*>(count)[tid] = make_uint4(0, 0, 0, 0);\n    __syncthreads();\n"
     "    // 1. each warp ranks", "    if (sizeof(Rec) == 4 && shift == 0) PH(11);\n", False, 2),
    ("    // 2. the block's bases over (digit, warp), digit-major",
     "    if (sizeof(Rec) == 4 && shift == 0) PH(12);\n", False, 1),
    ("    // 3. scatter into b at the block's base",
     "    if (sizeof(Rec) == 4 && shift == 0) PH(13);\n", False, 1),
    ("    // 4. the cluster's bases: the keys", "    if (sizeof(Rec) == 4 && shift == 0) PH(14);\n",
     False, 1),
    ("    // 5. copy b in order to the blocks", "    if (sizeof(Rec) == 4 && shift == 0) PH(15);\n",
     False, 1),
    ("    turn ^= 1;\n  }\n}", "    if (sizeof(Rec) == 4 && shift == 0) PH(16);\n", False, 1),
)
SORT_PASS = ("zero_and_rank", "block_bases", "local_scatter_and_sync", "cluster_bases",
             "copy_and_sync")

HEAD = """
__device__ unsigned long long g_phase[2][32];
#define PH(i) do { if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1)) \\
  g_phase[blockIdx.x == 0 ? 0 : 1][i] = clock64(); } while (0)
"""
TAIL = """
__global__ void cluster_sync_loop(unsigned long long* out, int n) {
  cg::cluster_group g = cg::this_cluster();
  g.sync();
  const unsigned long long t0 = clock64();
  for (int i = 0; i < n; ++i) g.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = clock64() - t0;
}
extern "C" int ss_cluster_sync_cycles(int c, int n, unsigned long long* host) {
  unsigned long long* d = nullptr;
  cudaError_t e = cudaMalloc(&d, 8);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaFuncSetAttribute(cluster_sync_loop, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(1024);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cluster_sync_loop, d, n);
  if (e == cudaSuccess) e = cudaMemcpy(host, d, 8, cudaMemcpyDeviceToHost);
  cudaFree(d);
  return static_cast<int>(e);
}
extern "C" int ss_phase_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase)));
}
"""


def patched_source() -> str:
    src = (build.CSRC / "ss_ingest.cu").read_text()
    anchor = "constexpr int32_t kEmpty = -1;\n"
    src = src.replace(anchor, anchor + HEAD, 1)
    for text, mark, after, nth in MARKS:
        at = -1
        for _ in range(nth):
            at = src.index(text, at + 1)
        at += len(text) if after else 0
        src = src[:at] + mark + src[at:]
    return src + TAIL


def load_patched() -> ctypes.CDLL:
    """Build the patched copy and make the wrapper launch it."""
    out = Path(build.BUILD_DIR).parent / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ss_ingest.cu").write_text(patched_source())
    lib_path = out / "ss_ingest_phases.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                           "-o", str(lib_path), str(out / "ss_ingest.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on the patched copy:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    build._libs["ss_ingest"] = lib
    ss_ingest._entry.cache_clear()
    lib.ss_phase_read.argtypes = [ctypes.c_void_p]
    lib.ss_cluster_sync_cycles.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=";".join(DEFAULT_CASES),
                    help="';'-separated flushes B,k,W,C (int32 counts)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/cluster_phases.py needs a CUDA card")
    lib = load_patched()
    buf = (ctypes.c_ulonglong * 64)()
    for c in ss_ingest.CLUSTER_SIZES:
        if lib.ss_cluster_sync_cycles(c, 1000, buf):
            raise SystemExit(f"the cluster.sync loop failed at C {c}")
        print(json.dumps({"C": c, "cluster_sync_cycles": buf[0] / 1000}), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for spec in args.cases.split(";"):
        b, k, w, c = map(int, spec.split(","))
        items = np.stack([rng.permutation(4 * k)[:k] for _ in range(b)]).astype(np.int32)
        counts = rng.integers(1, 1000, (b, k)).astype(np.int32)
        s = tuple(torch.from_numpy(a).to(dev) for a in (items, counts, counts // 4))
        win = torch.from_numpy(np.minimum(rng.zipf(1.1, (b, w)), 10**6).astype(np.int32)).to(dev)
        for _ in range(3):
            got = ss_ingest._fused_ingest(*s, win, path="cluster", c=c)
        torch.cuda.synchronize()
        if not all(torch.equal(a, x) for a, x in zip(got, ref.fused_ingest_ref(*s, win))):
            raise SystemExit(f"{spec}: the patched kernel is not bitwise its plain version")
        lib.ss_phase_read(buf)
        for block in (0, 1):
            t = [buf[32 * block + i] for i in range(18)]
            print(json.dumps({
                "case": {"B": b, "k": k, "W": w, "C": c},
                "block": "first" if block == 0 else "last",
                "cycles": {**{p: t[i + 1] - t[i] for i, p in enumerate(PHASES)},
                           "final_sync": t[17] - t[10]},
                "window_sort_first_pass": {p: t[12 + i] - t[11 + i]
                                           for i, p in enumerate(SORT_PASS)},
                "total": t[17] - t[0]}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
