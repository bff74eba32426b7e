"""The shared-memory flush kernel on one CUDA card: its time beside another
source's, and where its time goes, phase by phase.

    PYTHONPATH=src python tools/smem_phases.py [--parent PATH]

Builds ``src/repro_torch/csrc/ss_ingest.cu`` (the change) and, with
``--parent``, another version of that file (a parent commit's:
``git show <commit>:src/repro_torch/csrc/ss_ingest.cu > build/parent/ss_ingest.cu``
before the run) into ``build/smem_phases/``, each twice: as it is, and with
``clock64()`` marks at the phase boundaries of ``fused_ingest_kernel``
(recorded by thread 0 of the grid's first and last block; the marks cost a
few stores a phase). Every build is driven through the port's wrapper on the
shared-memory path, so the kernel measured is the one the wrapper launches,
and every output is held bit for bit against the plain version first. A
source whose shared-memory flush entry takes no salt (the kernels before
the table's hash was keyed) is called without the wrapper's salt.

Cases: ``chip_smoke.py``'s shared-memory flush cases, built the same way
(``flush``: B 64, k 2048, W 16 384, the summaries after one zipf(1.1)
window of the stream and the next window; ``flush_skew_1_8`` the same at
zipf 1.8; ``int64``, ``big_ids``, ``all_distinct``, ``one_chain``,
``chain_distinct`` and the rest as named there). Prints
one JSON line a case and source with the unmarked build's ms per call (CUDA
events over a loop of wrapper calls) and device ms (``torch.profiler``),
timed in turns parent, change, change, parent; then one a case, source and
block with the marked build's SM cycles per phase; then the card's name and
power limit. The sources themselves are not changed.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.spacesaving import EMPTY, Summary
from repro_torch.data.synthetic import zipf_stream
from repro_torch.kernels import build, ops, ref, ss_ingest

B, K, W = 64, 2048, 16384
OUT = Path(build.BUILD_DIR).parent / "smem_phases"

# (anchor, after the anchor?) of each mark in each version of
# fused_ingest_kernel, at the anchor's first occurrence in the file (the old
# version's select, compaction and winners' sort are keep_top_k's); mark i
# ends phase i - 1, and mark 0 starts the kernel
OLD_PHASES = ("load", "min_frequency", "window_sort", "run_starts", "match", "select",
              "compaction", "winners_sort", "output")
OLD_MARKS = (
    ("  window += b * w;\n", True),
    ("  const T m1 = min_frequency(items, counts, k, sh);   // before the update", False),
    ("  if (radix_sort<uint32_t>(IdKey{}, ids, pos, w, count, sh) == pos) {", False),
    ("  const int n_runs = run_starts(ids, pos, w, sh);", False),
    ("  // match + offsets (m2 = 0, no candidate errors): a matched slot gains its", False),
    ("  keep_top_k(IngestPool<T>{items, counts, errors, ids, pos, k, m1}", False),
    ("  const T thr = take_all ? T(-1) : static_cast<T>(prefix);", False),
    ("  // 3. order the winners, 4. write them out; slots past them are empty", False),
    ("  for (int i = tid; i < k; i += kThreads) {\n    int32_t item = kEmpty;", False),
    ("             o_errors + b * k);\n", True),
)
NEW_PHASES = ("load", "min_frequency", "insert", "match", "compaction", "select", "ties",
              "winners", "winners_sort", "output")
NEW_MARKS = (
    ("  const int32_t* row = window + b * w;\n", True),
    ("  const T m1 = min_frequency(items, counts, k, sh);   // before the update", False),
    ("  // 2. the window's exact histogram", False),
    ("  // 3. match + offsets", False),
    ("  // 4. the unmatched ids move", False),
    ("  // 5. the k-th largest count", False),
    ("  // 6. the summary's winners in slot order", False),
    ("  // 7. the winners: those above thr as keys", False),
    ("    const int n_sort = sort_slots(n_above), n_sort_tied = sort_slots(n_tied);", False),
    ("    const int tied_at = n_above + ties_s - ties_first, n_sel = tied_at + n_tied;", False),
    ("      o_errors[b * k + n_above + tie] = errors[v];\n      ++tie;\n    }\n", True),
)
HEAD = """
__device__ unsigned long long g_phase[2][16];
#define PH(i) do { if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1)) \\
  g_phase[blockIdx.x == 0 ? 0 : 1][i] = clock64(); } while (0)
"""
TAIL = """
extern "C" int ss_phase_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase)));
}
"""


def marked(src: str) -> tuple[str, tuple[str, ...]]:
    """The source with its phase marks, and the names of its phases."""
    new = "insert_ids(" in src
    marks, phases = (NEW_MARKS, NEW_PHASES) if new else (OLD_MARKS, OLD_PHASES)
    anchor = "constexpr int32_t kEmpty = -1;\n"
    src = src.replace(anchor, anchor + HEAD, 1)
    for i, (text, after) in enumerate(marks):    # each anchor's first occurrence
        at = src.index(text) + (len(text) if after else 0)
        src = src[:at] + f"  PH({i});\n" + src[at:]
    return src + TAIL, phases


def build_all(sources: dict[str, Path]) -> dict[str, Path]:
    """Compile each (tag, source) as it is and marked, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    texts = {}
    for tag, path in sources.items():
        src = path.read_text()
        texts[f"{tag}_plain"], texts[f"{tag}_marked"] = src, marked(src)[0]
    procs = {}
    for name, text in texts.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        lib = OUT / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lines = [ln.strip() for ln in log.splitlines()]
        ptxas = [lines[i + 1:i + 4] for i, ln in enumerate(lines)
                 if "Compiling entry function" in ln and "fused_ingest_kernelI" in ln]
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
        libs[name] = lib
    return libs


ENTRY = ss_ingest._entry


@functools.cache
def unsalted_entry(kernel, path, dtype):
    """The wrapper's C entry for a source whose shared-memory flush takes no
    salt: the salt the wrapper passes is dropped."""
    fn = ENTRY(kernel, path, dtype)
    if (kernel, path) != ("ingest", "smem"):
        return fn
    fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]
    return lambda *args: fn(*args[:-2], args[-1])


def use(lib_path: Path, salted: bool = True) -> ctypes.CDLL:
    """Make the wrapper launch the kernels of this library."""
    lib = ctypes.CDLL(str(lib_path))
    build._libs["ss_ingest"] = lib
    ENTRY.cache_clear()
    unsalted_entry.cache_clear()
    ss_ingest._entry = ENTRY if salted else unsalted_entry
    return lib


def one_chain_ids(n, w, floor):
    """n distinct ids above ``floor`` whose home slot under the public
    Fibonacci hash (x · 0x9E3779B1 mod 2^32, reduced to table_slots(w)
    slots by the high half of a product) is slot 0: one probe chain of a
    table with that hash."""
    n_slots = ss_ingest.table_slots(w)
    y = np.arange((2**32 - 1) // n_slots, dtype=np.uint64)
    x = (y * pow(0x9E3779B1, -1, 2**32)) & 0xFFFFFFFF
    ids = x[(x > floor) & (x < 2**31 - 1)][:n]
    assert len(ids) == n and not (((ids * 0x9E3779B1) & 0xFFFFFFFF) * n_slots >> 32).any()
    return ids.astype(np.int32)


def cases(dev):
    """The flushes timed, ``chip_smoke.py``'s shared-memory cases built the
    same way: (name, summaries, window)."""
    rng = np.random.default_rng(0)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def random_summary(b, k, fill, count_hi, id_range):
        items = np.full((b, k), EMPTY, np.int32)
        counts = np.zeros((b, k), np.int32)
        n = int(k * fill)
        for i in range(b):
            slots = rng.permutation(k)[:n]
            items[i, slots] = rng.choice(id_range, n, replace=False)
            counts[i, slots] = rng.integers(1, count_hi, n)
        return Summary(on_card(items), on_card(counts), on_card(counts // 4))

    def widened(s, offset=1 << 33):
        return Summary(s.items, s.counts.long() + offset, s.errors.long() + offset)

    def raised(s, offset, dtype):
        counts = torch.where(s.items != EMPTY, s.counts.to(dtype) + offset, 0)
        return Summary(s.items, counts, counts // 4)

    def main_state(skew):
        ids = on_card(zipf_stream(B * 2 * W, skew, seed=1, max_id=10**6).reshape(B, 2 * W))
        s0 = Summary(torch.full((B, K), EMPTY, dtype=torch.int32, device=dev),
                     torch.zeros((B, K), dtype=torch.int32, device=dev),
                     torch.zeros((B, K), dtype=torch.int32, device=dev))
        return (Summary(*ops.ingest_window(*s0, ids[:, :W], impl="sorted")),
                ids[:, W:].contiguous())

    summ, nxt = main_state(1.1)
    summ18, nxt18 = main_state(1.8)
    rows8 = Summary(*(a[:8].contiguous() for a in summ))
    half_empty = Summary(*(torch.where(torch.arange(K, device=dev) < K // 2, a, z)
                           for a, z in zip(summ, (EMPTY, 0, 0))))
    big_win = rng.integers(-2**31, 2**31, (8, W)).astype(np.int32)
    big_win[:, ::5] = EMPTY
    big_win[:, 1::11] = 2**31 - 1
    big_win[1, :W // 2] = rows8.items[1].cpu().numpy()[rng.integers(0, K, W // 2)]
    vary_win = rng.integers(1 << 24, 1 << 30, (8, W)).astype(np.int32)
    vary_win[rng.random((8, W)) < 0.3] = EMPTY
    equal_win = np.full((8, W), 7, np.int32)
    equal_win[1] = int(rows8.items[1, 3])
    distinct = np.stack([rng.permutation(8 * K)[:W] for _ in range(8)]).astype(np.int32)
    base = random_summary(8, K, 1.0, 40, 8 * K)
    chain = one_chain_ids(W, W, 10**6)
    chain_items = rows8.items.clone()
    chain_items[1, :1024] = on_card(chain[:1024])
    one_id = np.full((8, W), EMPTY, np.int32)
    one_id[:, ::2] = 123457
    one_id[1, ::2] = int(rows8.items[1, 9])
    return [
        ("flush", summ, nxt),
        ("int64", widened(summ), nxt),
        ("empty_window", summ, torch.full_like(nxt, EMPTY)),
        ("ties", random_summary(8, K, 1.0, 4, 8000),
         on_card(rng.integers(0, 6000, (8, W)).astype(np.int32))),
        ("partial", Summary(*(a[:16].contiguous() for a in half_empty)), nxt[:16].contiguous()),
        ("ragged", random_summary(5, 300, 0.6, 1000, 2400),
         on_card(np.minimum(rng.zipf(1.2, (5, 100)), 2399).astype(np.int32))),
        ("big_ids", rows8, on_card(big_win)),
        ("big_ids_int64", widened(rows8), on_card(big_win)),
        ("high_digits_constant", rows8,
         on_card(rng.integers(0, 1 << 16, (8, W)).astype(np.int32))),
        ("all_digits_vary", rows8, on_card(vary_win)),
        ("w_not_pow2", rows8, nxt[:8, :12345].contiguous()),
        ("all_equal", rows8, on_card(equal_win)),
        ("all_distinct", rows8, on_card(distinct)),
        ("big_counts", raised(base, 2**24 + 5, torch.int32), nxt[:8].contiguous()),
        ("big_counts_int64", raised(base, 2**32 + 5, torch.int64), nxt[:8].contiguous()),
        ("flush_skew_1_8", summ18, nxt18),
        ("all_distinct_b64_int64", widened(summ), on_card(np.stack(
            [rng.permutation(8 * K)[:W] for _ in range(B)]).astype(np.int32))),
        ("one_chain", Summary(chain_items, rows8.counts, rows8.errors),
         on_card(chain[rng.integers(0, 2048, (8, W))])),
        ("chain_distinct", rows8, on_card(np.stack([rng.permutation(chain) for _ in range(8)]))),
        ("one_id_and_empty", rows8, on_card(one_id)),
        ("k_1", Summary(*(a[:, :1].contiguous() for a in summ)), nxt),
    ]


def time_case(s, win, reps=20):
    """(ms per call, device ms) of the wrapper's shared-memory launch."""
    from torch.profiler import ProfilerActivity, profile

    def launch():
        return ss_ingest._fused_ingest(*s, win, path="smem")

    launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    total = n = 0
    for ev in prof.key_averages():
        if "fused_ingest_kernel" in ev.key:
            total += getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
            n += ev.count
    return ms, (total / n / 1e3 if n else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another version of csrc/ss_ingest.cu to time beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/smem_phases.py needs a CUDA card")
    dev = torch.device("cuda")
    sources = {"change": build.CSRC / "ss_ingest.cu"}
    if args.parent:
        sources = {"parent": args.parent, **sources}
    libs = build_all(sources)
    salted = {tag: "salt" in path.read_text() for tag, path in sources.items()}
    flushes = cases(dev)
    want = {name: ref.fused_ingest_ref(*s, win) for name, s, win in flushes}
    for tag in sources:                       # bitwise first, each build
        for kind in ("plain", "marked"):
            use(libs[f"{tag}_{kind}"], salted[tag])
            for name, s, win in flushes:
                got = ss_ingest._fused_ingest(*s, win, path="smem")
                torch.cuda.synchronize()
                if not all(torch.equal(a, x) for a, x in zip(got, want[name])):
                    raise SystemExit(f"{tag} {kind} {name}: not bitwise the plain version")
    print(json.dumps({"bitwise": sorted(want), "builds": sorted(libs)}), flush=True)
    order = list(sources) + list(sources)[::-1]      # parent, change, change, parent
    for name, s, win in flushes:
        for turn, tag in enumerate(order):
            use(libs[f"{tag}_plain"], salted[tag])
            ms, dev_ms = time_case(s, win)
            print(json.dumps({"case": name, "source": tag, "turn": turn,
                              "shape": {"B": s.items.shape[0], "k": s.items.shape[1],
                                        "W": win.shape[1]},
                              "dtype": str(s.counts.dtype), "ms": ms, "device_ms": dev_ms}),
                  flush=True)
    buf = (ctypes.c_ulonglong * 32)()
    for tag, path in sources.items():
        phases = marked(path.read_text())[1]
        lib = use(libs[f"{tag}_marked"], salted[tag])
        lib.ss_phase_read.argtypes = [ctypes.c_void_p]
        for name, s, win in flushes:
            for _ in range(3):
                ss_ingest._fused_ingest(*s, win, path="smem")
            torch.cuda.synchronize()
            lib.ss_phase_read(buf)
            for block in (0, 1):
                t = [buf[16 * block + i] for i in range(len(phases) + 1)]
                print(json.dumps({
                    "case": name, "source": tag, "block": "first" if block == 0 else "last",
                    "cycles": {p: t[i + 1] - t[i] for i, p in enumerate(phases)},
                    "total": t[-1] - t[0]}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
