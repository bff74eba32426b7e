"""The dry run's trip-counted attention tile loop (``launch/hlo_analysis.py:
uniform_loop``, the one loop ``models/attention.py:blockwise_attention``
declares uniform) against the same loop counted every iteration.

On fake tensors with no autograd graph, under ``analyze``, the loop runs
its first tile only and the counters add that tile's counts once for each
other tile, as JAX's analysis counts a ``lax.scan`` body times its trip
count. Here:

  * ``blockwise_attention`` alone on fake tensors, where the tiles'
    temporaries make the step's peak: every count and every memory field
    equal to the eager loop's, under both schedules, with a sliding window
    and a chunked prefill's ``q_offset``; one tile run;
  * on real tensors, and on fake ones that take gradients, every tile runs
    (the outputs of the real ones equal the uncounted function's);
  * in one subprocess (``OMP_NUM_THREADS=1``; its default group never
    enters the test worker), ``dryrun.count_step`` of the smoke prefills of
    qwen2.5-14b (GQA), minicpm3-4b (MLA's latent prefill) and zamba2-7b
    (the shared attention block) on a fake world of 8 ranks, ``(2, 4)``
    ``data × model``, B 8 × S 3 072 (6 blocks of 512: 21 tiles a layer under
    ``band``, 36 under ``masked``): the trip-counted record equals the eager
    one exactly in ``flops_per_device``, ``bytes_per_device``,
    ``collectives``, ``wire_bytes_per_device``, ``memory`` and
    ``xla_cost_raw``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import hlo_analysis as HA
from repro_torch.models import attention as A

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2.5-14b", "minicpm3-4b", "zamba2-7b")
SEQ, BATCH = 3072, 8
KEYS = ("flops_per_device", "bytes_per_device", "collectives", "wire_bytes_per_device",
        "memory", "xla_cost_raw")


def _eager(trips, *_):
    return trips


def _counted(monkeypatch, loop, fn, *args):
    """``analyze(fn, *args)`` with ``loop`` as the attention's tile loop, and
    how many tiles ran."""
    tiles = []
    real = A._tile
    monkeypatch.setattr(A, "_tile", lambda *a: tiles.append(1) or real(*a))
    monkeypatch.setattr(A, "uniform_loop", loop)
    out = HA.analyze(fn, *args)
    return out, len(tiles)


CASES = {   # (B, S, H, KV, hd), keyword arguments, tiles
    "band": ((2, 1024, 4, 2, 64), dict(schedule="band", block_q=128, block_kv=128), 36),
    "masked": ((2, 1024, 4, 2, 64), dict(schedule="masked", block_q=128, block_kv=256), 32),
    "window": ((2, 1024, 4, 4, 32), dict(schedule="band", block_q=128, block_kv=128,
                                         window=300), 26),
    "q_offset": ((1, 512, 4, 1, 64), dict(schedule="band", block_q=128, block_kv=128,
                                          q_offset=512), 26),
}
SMALL = (1, 512, 2, 1, 32)      # on real tensors: 10 tiles under band, 8 under masked


def _qkv(b, s, h, kv, hd, q_offset=0):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((b, s, h, hd), generator=g),
            torch.randn((b, s + q_offset, kv, hd), generator=g),
            torch.randn((b, s + q_offset, kv, hd), generator=g))


@pytest.mark.parametrize("case", list(CASES))
def test_fake_tiles_counted_once_times_the_trips(case, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    dims, kw, n_tiles = CASES[case]
    with FakeTensorMode(allow_non_fake_inputs=True):
        q, k, v = _qkv(*dims, q_offset=kw.get("q_offset", 0))
    fn = lambda q, k, v: A.blockwise_attention(q, k, v, **kw)  # noqa: E731
    with torch.no_grad():
        trip, ran = _counted(monkeypatch, HA.uniform_loop, fn, q, k, v)
        eager, ran_eager = _counted(monkeypatch, _eager, fn, q, k, v)
    assert (ran, ran_eager) == (1, n_tiles)
    assert trip == eager
    # the tiles' score temporaries (B, H, Bq, Bkv) f32 make the peak, not
    # the inputs and the output
    b, s, h, _, hd = dims
    assert trip["memory"]["temp_bytes"] > 2 * b * h * 128 * 128 * 4


@pytest.mark.parametrize("case, n_tiles", [("band", 10), ("masked", 8)])
def test_real_tensors_run_every_tile(case, n_tiles, monkeypatch):
    kw = CASES[case][1]
    q, k, v = _qkv(*SMALL)
    want = A.blockwise_attention(q, k, v, **kw)
    fn = lambda q, k, v: A.blockwise_attention(q, k, v, **kw)  # noqa: E731
    with torch.no_grad():
        (trip, ran), (eager, _) = (_counted(monkeypatch, HA.uniform_loop, fn, q, k, v),
                                   _counted(monkeypatch, _eager, fn, q, k, v))
    assert ran == n_tiles and trip == eager
    monkeypatch.setattr(A, "uniform_loop", HA.uniform_loop)
    with torch.no_grad(), HA.StepCounter():
        assert torch.equal(A.blockwise_attention(q, k, v, **kw), want)


def test_fake_tensors_under_autograd_run_every_tile(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    dims, kw, n_tiles = CASES["band"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        q, k, v = (t.requires_grad_(True) for t in _qkv(*dims))
    _, ran = _counted(monkeypatch, HA.uniform_loop,
                      lambda q, k, v: A.blockwise_attention(q, k, v, **kw), q, k, v)
    assert ran == n_tiles


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("trip") / "records.json"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("schedule, trips", [("band", 21), ("masked", 36)])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_trip_counted_equals_eager(records, arch, schedule, trips):
    rec = records[f"{arch}/{schedule}"]
    # one tile an attention when trip-counted, every tile when eager
    assert rec["tiles"]["trip"] > 0 and rec["tiles"]["eager"] == trips * rec["tiles"]["trip"]
    assert rec["trip"] == rec["eager"]


def smoke_prefills() -> dict:
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.sharding.rules import ShardingPlan

    dryrun.fake_world(8)
    mesh = make_mesh_shape((2, 4), ("data", "model"), device_type="cpu")
    shape = ShapeConfig("smoke_prefill", SEQ, BATCH, "prefill")
    real_loop, real_tile = A.uniform_loop, A._tile
    tiles = []
    A._tile = lambda *a: tiles.append(1) or real_tile(*a)
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_arch(arch)
        for schedule in ("band", "masked"):
            rec = {"tiles": {}}
            for mode, loop in (("trip", real_loop), ("eager", _eager)):
                A.uniform_loop = loop
                tiles.clear()
                r = dryrun.count_step(cfg, shape, ShardingPlan(cfg, mesh), schedule=schedule,
                                      device="cpu")
                rec[mode] = {k: r[k] for k in KEYS}
                rec["tiles"][mode] = len(tiles)
            out[f"{arch}/{schedule}"] = rec
    A.uniform_loop, A._tile = real_loop, real_tile
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    Path(sys.argv[1]).write_text(json.dumps(smoke_prefills()))
