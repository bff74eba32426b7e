"""The sharded steps of mamba2-130m's smoke arch (2 Mamba-2 layers, d 128,
d_inner 256, 8 heads of 32 in 1 group, d_state 16, conv 4, SSD chunk 16,
f32) over 8 gloo ranks on a ``(2, 4)`` ``data × model`` mesh, held against
the port's single-process steps and JAX's by
``tests/test_torch_sharding_dist.py`` (see its docstring for every check
and bound). S 32 is two chunks, so the scan's inter-chunk loop runs.

Here also: the mixer's parameters in ``train_state_shardings``' placements
(``in_proj`` FSDP × ``ssm_in``, ``conv_w`` on its channels), the decode
cache in ``cache_shardings``' (``ssm_state``'s headdim and ``conv``'s
channels on ``model``), and the step writing layer 0's state and window
into the stacked cache's own shards. The collectives of one Mamba decode
layer as ``CommDebugMode`` saw them: the ``in_proj`` output and the conv
output gathered (the split at d_inner and at xs | B | C cuts through
``model`` shards), the new xs laid out on P as the state is and the
output y gathered; nothing of a state's or window's shape moved. The
prefill's: the ``in_proj`` output made whole (one all-gather of (B, S,
d_in_proj)) and split, the conv output gathered, and the final state moved
from the scan's heads to the cache's P (``ssm_layouts``, which also runs
``mamba_block`` and its backward in the two layouts of the scan the smoke
archs do not give: each rank's heads a whole group, and the headdim
sharded).

Under ``no_tp`` (``no_tp_decode``: the weights replicated, the batch on
``data``, the caches' window channels and state columns still on
``model``) the smoke arch's prefill, 2 decode steps and a train step at
B 4 are held against the single process's within the world's bounds (the
single process is held against JAX's step above), with no decode
redistribution of a cache's shape: the conv weights are laid out on the
window's channels, a slice of each rank's replica.
"""
import json

from test_torch_sharding_dist import check

ARCH, STRATEGY, SWA, LR = "mamba2-130m", "tp", None, (1e-2, 2, 10)
STATE, WINDOW = [4, 1, 8, 16, 32], [4, 3, 288]      # one layer's (B, G, Hg, N, P), (B, K-1, C)


def test_sharded_ssm_steps_match_single_process_and_jax(tmp_path, monkeypatch):
    out = check(tmp_path, monkeypatch, ARCH, STRATEGY, SWA, LR, extra="ssm_world")
    got, gaps = out["got"], out["gaps"]
    assert got["placement/layers.0.mixer.in_proj"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["placement/layers.0.mixer.conv_w"] == "(Replicate(), Shard(dim=1))"
    assert got["placement/layers.0.mixer.out_proj"] == "(Shard(dim=1), Shard(dim=0))"
    assert got["placement/layers.0.mixer.A_log"] == "(Replicate(), Replicate())"
    assert got["placement/cache_ssm_state"] == "(Shard(dim=1), Shard(dim=5))"   # batch, P
    assert got["placement/cache_conv"] == "(Shard(dim=1), Shard(dim=3))"        # batch, channels
    assert bool(got["state_written_in_place"])

    moves = gaps["comm"]["redistributions"]
    assert not [m for m in moves if m[2] in (STATE, WINDOW)], moves
    # the in_proj output made whole before its split; the conv output (B, 1,
    # conv_dim) and the output y (B, G, Hg, P) gathered
    assert ["(Shard(dim=0), Shard(dim=2))", "(Shard(dim=0), Replicate())", [4, 1, 288]] in moves
    assert ["(Shard(dim=0), Shard(dim=3))", "(Shard(dim=0), Replicate())",
            [4, 1, 8, 32]] in moves
    assert any(shape == [4, 1, 552] and dst == "(Shard(dim=0), Replicate())"
               for _, dst, shape in moves), moves
    # a few KB a rank: no state (16 KB a rank's shard) crossed the mesh
    assert sum(gaps["comm"]["bytes"].values()) < 16 * 1024

    prefill = json.loads(str(got["comm_prefill"]))["redistributions"]
    assert ["(Shard(dim=0), Shard(dim=2))", "(Shard(dim=0), Replicate())",
            [4, 32, 552]] in prefill
    assert ["(Shard(dim=0), Shard(dim=2))", "(Shard(dim=0), Replicate())",
            [4, 32, 288]] in prefill
    assert ["(Shard(dim=0), Shard(dim=1))", "(Shard(dim=0), Shard(dim=3))",
            [4, 8, 16, 32]] in prefill                       # heads -> P, once a layer
    for label, blhp in (("smoke", ["data", "None", "model", "None"]),
                        ("whole_groups", ["data", "None", "model", "None"]),
                        ("headdim", ["data", "None", "None", "model"])):
        layout = json.loads(str(got[f"ssm_layout/{label}"]))
        print(label, layout)
        assert layout["blhp"] == blhp
        assert layout["out"] <= 1e-5 and layout["h_final"] <= 1e-5
        assert layout["h_final_placements"] == "(Shard(dim=0), Shard(dim=4))"
        assert max(layout["grads_rel"].values()) <= 1e-4
        assert layout["dtensor_out"]

    no_tp = json.loads(str(got["no_tp_decode"]))
    print("no_tp_decode", no_tp)
    assert no_tp["prefill"] <= 1e-5 and no_tp["tokens_equal"]
    assert no_tp["loss_rel"] <= 1e-5 and no_tp["grads_rel"] <= 1e-5
    assert no_tp["params_lr"] <= 0.1
    assert no_tp["decode_moves_cache_shaped"] == 0
