"""A shared-memory fused kernel on one CUDA card: its time beside another
source's, and where its time goes, phase by phase.

    PYTHONPATH=src python tools/smem_phases.py [--kernel ingest|combine] [--parent PATH]

Builds ``src/repro_torch/csrc/ss_ingest.cu`` (the change) and, with
``--parent``, another version of that file (a parent commit's:
``git show <commit>:src/repro_torch/csrc/ss_ingest.cu > build/parent/ss_ingest.cu``
before the run) into ``build/smem_phases/``, each twice: as it is, and with
``clock64()`` marks at the phase boundaries of the kernel (``--kernel
ingest``: ``fused_ingest_kernel``, the flush; ``combine``:
``fused_combine_kernel``, a COMBINE round), recorded by thread 0 of the
grid's first and last block (the marks cost a few stores a phase). Every
build is driven through the port's wrapper on the shared-memory path, so
the kernel measured is the one the wrapper launches, and every output is
held bit for bit against the plain version first. A source whose
shared-memory entry takes no salt (the flush before its table's hash was
keyed, the COMBINE before it had a table) is called without the wrapper's
salt.

Cases: ``chip_smoke.py``'s shared-memory cases of that kernel, built the
same way. Flush: ``flush`` (B 64, k 2048, W 16 384, the summaries after one
zipf(1.1) window of the stream and the next window), ``flush_skew_1_8`` the
same at zipf 1.8, ``int64``, ``big_ids``, ``all_distinct``, ``one_chain``,
``chain_distinct`` and the rest as named there. COMBINE: ``combine`` (B 32
pairs of those summaries, k 2048), ``int64``, ``ties``, ``partial``,
``ragged``, ``big_counts``, ``big_counts_int64``, the tree's last rounds
``tree_b4`` and ``tree_b1``, ``disjoint``, ``identical``, ``k_1`` and
``one_chain``. Prints one JSON line a case and source with the unmarked
build's ms per call (CUDA events over a loop of wrapper calls) and device
ms (``torch.profiler``), timed in turns parent, change, change, parent;
for COMBINE then the change's cluster kernel forced onto k 2048 pairs
(clusters of 2 and 4 blocks, at 1, 4 and 32 pairs) beside its
shared-memory kernel on the same inputs; then one line a case, source and
block with the marked build's SM cycles per phase; then the card's name
and power limit. The sources themselves are not changed.
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

# (anchor, after the anchor?) of each mark in each version of each kernel,
# at the anchor's first occurrence in the file (the old flush's and the old
# COMBINE's select, compaction and winners' sort are keep_top_k's); mark i
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
# the COMBINE that sorted s2's (id, slot) keys by a bitonic network
OLD_COMBINE_PHASES = ("load", "min_frequency", "key_sort", "match", "select", "compaction",
                      "winners_sort", "output")
OLD_COMBINE_MARKS = (
    ("  const int64_t off = static_cast<int64_t>(blockIdx.x) * k;\n", True),
    ("  const T m1 = min_frequency(items1, counts1, k, sh);   // before the update", False),
    ("  bitonic_sort(Ascending<long long>{keys}, pk);", False),
    ("  // match + offsets: both (c1 + c2, e1 + e2); s1 only (c1 + m2, e1 + m2);", False),
    ("  keep_top_k(CombinePool<T>{items1, counts1, errors1, items2, counts2, errors2, k, m1},",
     False),
    ("  const T thr = take_all ? T(-1) : static_cast<T>(prefix);", False),
    ("  // 3. order the winners, 4. write them out; slots past them are empty", False),
    ("  for (int i = tid; i < k; i += kThreads) {\n    int32_t item = kEmpty;", False),
    ("             o_errors + off);\n", True),
)
# the COMBINE that hashes s2's ids (load: both summaries, the table
# emptied; partials: each warp's m1, m2 partials; build: the table; m1_m2:
# the warps' partials reduced; pool: s2's slots and the block's totals)
NEW_COMBINE_PHASES = ("load", "partials", "build", "m1_m2", "probe", "pool", "select", "scan",
                      "keys", "winners_sort", "output")
NEW_COMBINE_MARKS = (
    ("  // 1. load: where k is a multiple of 4 and the six tensors start on", False),
    ("    // min_frequency of both summaries, a warp's share", False),
    ("  // 2. build: s2's valid ids into the table", False),
    ("  T m1, m2;\n", False),
    ("  // 3. probe + offsets: both (c1 + c2, e1 + e2)", False),
    ("  // 4. s2's slots as pool entries", False),
    ("  // 5. the k-th largest count thr: k or fewer valid entries all win\n", False),
    ("  // 6. each thread's contiguous range of the pool", False),
    ("  // 7. the winners' keys at their places", False),
    ("    const int n_sort = sort_slots(n_sel);", False),
    ("    if (n_sel > 1) bitonic_sort_keys(buf, n_sort);\n", True),
    ("      o_errors[off + i] = e;\n    }\n", True),
)
KERNEL_NAME = {"ingest": "fused_ingest_kernel", "combine": "fused_combine_kernel"}
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


def marked(src: str, kernel: str) -> tuple[str, tuple[str, ...]]:
    """The source with its phase marks in ``kernel``'s kernel, and the names
    of its phases."""
    if kernel == "ingest":
        new = "insert_ids(" in src
        marks, phases = (NEW_MARKS, NEW_PHASES) if new else (OLD_MARKS, OLD_PHASES)
    else:
        new = "insert_slot(" in src
        marks, phases = ((NEW_COMBINE_MARKS, NEW_COMBINE_PHASES) if new
                         else (OLD_COMBINE_MARKS, OLD_COMBINE_PHASES))
    anchor = "constexpr int32_t kEmpty = -1;\n"
    src = src.replace(anchor, anchor + HEAD, 1)
    for i, (text, after) in enumerate(marks):    # each anchor's first occurrence
        at = src.index(text) + (len(text) if after else 0)
        src = src[:at] + f"  PH({i});\n" + src[at:]
    return src + TAIL, phases


def salted(src: str, kernel: str) -> bool:
    """Whether the source's shared-memory entry of ``kernel`` takes a salt."""
    entry = src[src.index(f'extern "C" int ss_fused_{kernel}_i32('):]
    return "salt" in entry[:entry.index("{")]


def build_all(sources: dict[str, Path], kernel: str) -> dict[str, Path]:
    """Compile each (tag, source) as it is and marked, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    texts = {}
    for tag, path in sources.items():
        src = path.read_text()
        texts[f"{tag}_plain"], texts[f"{tag}_marked"] = src, marked(src, kernel)[0]
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
                 if "Compiling entry function" in ln and KERNEL_NAME[kernel] + "I" in ln]
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
        libs[name] = lib
    return libs


ENTRY = ss_ingest._entry


@functools.cache
def unsalted_entry(kernel, path, dtype):
    """The wrapper's C entry for a source whose shared-memory entry takes no
    salt: the salt the wrapper passes is dropped."""
    fn = ENTRY(kernel, path, dtype)
    if path != "smem":
        return fn
    fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]
    return lambda *args: fn(*args[:-2], args[-1])


def use(lib_path: Path, salted_kernel: dict[str, bool]) -> ctypes.CDLL:
    """Make the wrapper launch the kernels of this library; an entry whose
    kernel takes no salt there (``salted_kernel``) is called without one."""
    lib = ctypes.CDLL(str(lib_path))
    build._libs["ss_ingest"] = lib
    ENTRY.cache_clear()
    unsalted_entry.cache_clear()
    ss_ingest._entry = lambda kernel, path, dtype: (
        ENTRY if salted_kernel[kernel] else unsalted_entry)(kernel, path, dtype)
    return lib


def one_chain_ids(n, n_slots, floor):
    """n distinct ids above ``floor`` whose home slot under the public
    Fibonacci hash (x · 0x9E3779B1 mod 2^32, reduced to n_slots slots by
    the high half of a product) is slot 0: one probe chain of a table with
    that hash."""
    y = np.arange((2**32 - 1) // n_slots, dtype=np.uint64)
    x = (y * pow(0x9E3779B1, -1, 2**32)) & 0xFFFFFFFF
    ids = x[(x > floor) & (x < 2**31 - 1)][:n]
    assert len(ids) == n and not (((ids * 0x9E3779B1) & 0xFFFFFFFF) * n_slots >> 32).any()
    return ids.astype(np.int32)


class Inputs:
    """The cases' inputs on ``dev``, drawn from one seeded generator, as
    ``chip_smoke.py`` draws them."""

    def __init__(self, dev):
        self.dev = dev
        self.rng = np.random.default_rng(0)

    def on_card(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def random_summary(self, b, k, fill, count_hi, id_range):
        """(b, k) summaries: distinct ids in a random ``fill`` share of the slots."""
        items = np.full((b, k), EMPTY, np.int32)
        counts = np.zeros((b, k), np.int32)
        n = int(k * fill)
        for i in range(b):
            slots = self.rng.permutation(k)[:n]
            items[i, slots] = self.rng.choice(id_range, n, replace=False)
            counts[i, slots] = self.rng.integers(1, count_hi, n)
        return Summary(self.on_card(items), self.on_card(counts), self.on_card(counts // 4))

    def main_state(self, skew):
        """The summaries after one zipf window of the stream a tenant, and the next window."""
        ids = self.on_card(zipf_stream(B * 2 * W, skew, seed=1, max_id=10**6).reshape(B, 2 * W))
        s0 = Summary(torch.full((B, K), EMPTY, dtype=torch.int32, device=self.dev),
                     torch.zeros((B, K), dtype=torch.int32, device=self.dev),
                     torch.zeros((B, K), dtype=torch.int32, device=self.dev))
        return (Summary(*ops.ingest_window(*s0, ids[:, :W], impl="sorted")),
                ids[:, W:].contiguous())


def widened(s, offset=1 << 33):
    return Summary(s.items, s.counts.long() + offset, s.errors.long() + offset)


def raised(s, offset, dtype):
    """Counts raised above 2^24 or 2^32: ties that differ only in low digits."""
    counts = torch.where(s.items != EMPTY, s.counts.to(dtype) + offset, 0)
    return Summary(s.items, counts, counts // 4)


def flush_cases(dev):
    """The flushes timed, ``chip_smoke.py``'s shared-memory cases built the
    same way: (name, arguments of the wrapper)."""
    inputs = Inputs(dev)
    rng, on_card, random_summary = inputs.rng, inputs.on_card, inputs.random_summary
    summ, nxt = inputs.main_state(1.1)
    summ18, nxt18 = inputs.main_state(1.8)
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
    chain = one_chain_ids(W, ss_ingest.table_slots(W), 10**6)
    chain_items = rows8.items.clone()
    chain_items[1, :1024] = on_card(chain[:1024])
    one_id = np.full((8, W), EMPTY, np.int32)
    one_id[:, ::2] = 123457
    one_id[1, ::2] = int(rows8.items[1, 9])
    flushes = [
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
    return [(name, (*s, win)) for name, s, win in flushes]


def combine_cases(dev):
    """The COMBINE rounds timed, ``chip_smoke.py``'s shared-memory COMBINE
    cases built the same way: (name, arguments of the wrapper)."""
    inputs = Inputs(dev)
    random_summary = inputs.random_summary

    def rows(s, lo, hi):
        return Summary(*(a[lo:hi].contiguous() for a in s))

    summ = inputs.main_state(1.1)[0]
    pair = [a.reshape(B // 2, 2, K) for a in summ]
    s1 = Summary(*(a[:, 0].contiguous() for a in pair))
    s2 = Summary(*(a[:, 1].contiguous() for a in pair))
    half_empty = Summary(*(torch.where(torch.arange(K, device=dev) < K // 2, a, z)
                           for a, z in zip(summ, (EMPTY, 0, 0))))
    base_a, base_b = (random_summary(8, K, fill, 40, 8 * K) for fill in (1.0, 0.7))
    tie_pairs = [random_summary(8, K, fill, 4, 4000) for fill in (1.0, 0.8)]
    small2 = random_summary(5, 300, 1.0, 1000, 600)
    pairs = {
        "combine": (s1, s2),
        "int64": (widened(s1), widened(s2)),
        "ties": tuple(tie_pairs),
        "partial": (s1, rows(half_empty, 0, B // 2)),
        "ragged": (small2, random_summary(5, 300, 0.3, 1000, 600)),
        "big_counts": tuple(raised(x, 2**24 + 5, torch.int32) for x in (base_a, base_b)),
        "big_counts_int64": tuple(raised(x, 2**32 + 5, torch.int64) for x in (base_a, base_b)),
    }
    pairs.update(combine_edge_pairs(inputs, s1, s2))
    return [(name, (*a, *b)) for name, (a, b) in pairs.items()]


def combine_edge_pairs(inputs, s1, s2):
    """The COMBINE's edge cases: the tree's last rounds (4 pairs and 1 of the
    main state), disjoint and identical ids, k 1, ids of one home slot of
    the public Fibonacci hash in the join's table of join_slots(k) slots in
    both summaries, and counts spread over 2^30 (int32) and 2^60 (int64: the
    winners' 128-bit keys)."""
    rng, on_card, random_summary = inputs.rng, inputs.on_card, inputs.random_summary

    def rows(s, hi):
        return Summary(*(a[:hi].contiguous() for a in s))

    def spread(s, hi, dtype):
        counts = on_card(rng.integers(0, hi, tuple(s.items.shape), dtype=np.int64))
        counts = torch.where(s.items != EMPTY, counts, 0).to(dtype)
        return Summary(s.items, counts, counts // 3)

    dis_a, dis_b = (random_summary(8, K, 1.0, 1000, 4 * K) for _ in range(2))
    dis_b = Summary(torch.where(dis_b.items != EMPTY, dis_b.items + 4 * K, EMPTY),
                    dis_b.counts, dis_b.errors)
    same_b = random_summary(8, K, 1.0, 1000, 4 * K)
    same_b = Summary(on_card(np.stack([rng.permutation(r) for r in dis_a.items.cpu().numpy()])),
                     same_b.counts, same_b.errors)
    chain = one_chain_ids(2 * K, ss_ingest.join_slots(K), 10**6)
    chain_a, chain_b = (random_summary(8, K, 1.0, 1000, 4 * K) for _ in range(2))
    chain_a, chain_b = (Summary(on_card(np.stack([rng.permutation(chain)[:K] for _ in range(8)])),
                                x.counts, x.errors) for x in (chain_a, chain_b))
    return {
        "tree_b4": (rows(s1, 4), rows(s2, 4)),
        "tree_b1": (rows(s1, 1), rows(s2, 1)),
        "disjoint": (dis_a, dis_b),
        "identical": (dis_a, same_b),
        "k_1": tuple(Summary(*(a[:, :1].contiguous() for a in s)) for s in (s1, s2)),
        "one_chain": (chain_a, chain_b),
        "wide_counts": (spread(dis_a, 2**30, torch.int32), spread(same_b, 2**30, torch.int32)),
        "huge_counts_int64": (spread(dis_a, 2**60, torch.int64),
                              spread(same_b, 2**60, torch.int64)),
    }


def time_case(kernel, args, reps=20, path="smem", c=None):
    """(ms per call, device ms) of the wrapper's launch on ``path``."""
    from torch.profiler import ProfilerActivity, profile

    fn = ss_ingest._fused_ingest if kernel == "ingest" else ss_ingest._fused_combine
    name = KERNEL_NAME[kernel].replace("_kernel", "" if path == "smem" else f"_{path}") + "_kernel"

    def launch():
        return fn(*args, path=path, c=c)

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
        if name in ev.key:
            total += getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
            n += ev.count
    return ms, (total / n / 1e3 if n else None)


def shape_of(kernel, args):
    shape = {"B": args[0].shape[0], "k": args[0].shape[1]}
    if kernel == "ingest":
        shape["W"] = args[3].shape[1]
    return shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("ingest", "combine"), default="ingest",
                    help="the shared-memory flush (ingest) or COMBINE kernel")
    ap.add_argument("--parent", type=Path, default=None,
                    help="another version of csrc/ss_ingest.cu to time beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/smem_phases.py needs a CUDA card")
    dev = torch.device("cuda")
    kernel = args.kernel
    sources = {"change": build.CSRC / "ss_ingest.cu"}
    if args.parent:
        sources = {"parent": args.parent, **sources}
    libs = build_all(sources, kernel)
    salts = {tag: {kn: salted(path.read_text(), kn) for kn in ("ingest", "combine")}
             for tag, path in sources.items()}
    fn = ss_ingest._fused_ingest if kernel == "ingest" else ss_ingest._fused_combine
    plain = ref.fused_ingest_ref if kernel == "ingest" else ref.fused_combine_ref
    runs = flush_cases(dev) if kernel == "ingest" else combine_cases(dev)
    want = {name: plain(*a) for name, a in runs}
    for tag in sources:                       # bitwise first, each build
        for kind in ("plain", "marked"):
            use(libs[f"{tag}_{kind}"], salts[tag])
            for name, a in runs:
                got = fn(*a, path="smem")
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, want[name])):
                    raise SystemExit(f"{tag} {kind} {name}: not bitwise the plain version")
    print(json.dumps({"bitwise": sorted(want), "builds": sorted(libs)}), flush=True)
    order = list(sources) + list(sources)[::-1]      # parent, change, change, parent
    for name, a in runs:
        for turn, tag in enumerate(order):
            use(libs[f"{tag}_plain"], salts[tag])
            ms, dev_ms = time_case(kernel, a)
            print(json.dumps({"case": name, "source": tag, "turn": turn,
                              "shape": shape_of(kernel, a), "dtype": str(a[1].dtype),
                              "ms": ms, "device_ms": dev_ms}), flush=True)
    if kernel == "combine":
        # the cluster kernel forced onto the shared-memory path's k 2048, beside it
        use(libs["change_plain"], salts["change"])
        by_name = dict(runs)
        for name in ("tree_b1", "tree_b4", "combine"):
            a = by_name[name]
            for path, c in (("smem", None), ("cluster", 2), ("cluster", 4)):
                got = fn(*a, path=path, c=c)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, want[name])):
                    raise SystemExit(f"{name} {path} C {c}: not bitwise the plain version")
                ms, dev_ms = time_case(kernel, a, path=path, c=c)
                print(json.dumps({"case": name, "source": "change", "path": path, "C": c,
                                  "shape": shape_of(kernel, a), "dtype": str(a[1].dtype),
                                  "ms": ms, "device_ms": dev_ms}), flush=True)
    buf = (ctypes.c_ulonglong * 32)()
    for tag, path in sources.items():
        phases = marked(path.read_text(), kernel)[1]
        lib = use(libs[f"{tag}_marked"], salts[tag])
        lib.ss_phase_read.argtypes = [ctypes.c_void_p]
        for name, a in runs:
            for _ in range(3):
                fn(*a, path="smem")
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
