"""The sharded steps of zamba2-7b's smoke arch (4 Mamba-2 layers, d 128,
d_inner 256, 8 heads of 32 in 2 groups, d_state 16, conv 4, SSD chunk 16;
the shared attention block, 4 heads and d_ff 256, after layers 2 and 4;
f32) over 8 gloo ranks on a ``(2, 4)`` ``data × model`` mesh, held against
the port's single-process steps and JAX's by
``tests/test_torch_sharding_dist.py`` (see its docstring for every check).

8 heads on a ``model`` of 4 give each rank 2 heads of one group of 4: the
scan takes that group's B/C columns alone (``mamba2._local_groups``; the
other layouts are held here on whole tensors and in
``test_torch_sharding_ssm.py`` on the mesh). Here also: the placements of
the mixer and of the decode cache, the shared block's ``shared_k`` and
``shared_v`` sequence-sharded as k/v are (written at their position
through their shards), the step writing layer 0's state and window into
the stacked cache's own shards, and one Mamba decode layer's collectives:
nothing of a state's or window's shape moved.

This world's own bounds. zamba2's smoke gradients are more sensitive to
the order of f32 sums than the other families': JAX's single-device
gradients differ from the port's single-process ones by 1.10e-5 of
``dt_bias``'s largest (the sharded steps: 1.14e-5, and 5.5e-6 from
JAX's), so the gradients are held within 2e-5 of each leaf's largest
beside the port's (1e-4 beside JAX's, as every world). A few entries'
gradients lie at Adam's eps (1e-8) and are f32 noise in every package;
Adam moves such an entry by lr·g/(|g| + eps), a third of lr one way or
the other (JAX's first step moves them 0.34·lr from the port's), so the
parameters are held within 0.5·lr: a wrong, skipped or misplaced update
still moves an entry by about lr. The steps peak at lr 1e-6, as the MoE
worlds' do, so that those entries do not move the second step's loss and
gradient norm beyond 1e-5. The logits after 4 decode steps of 4 layers'
recurrences are held within 2e-5 (measured: 1.15e-5), the bound the
single-process port is held to against JAX's decode of the same smoke
archs (``tests/test_torch_lm_ssm.py``, ``test_torch_lm_model.ATOL``).
Also the steps with the residual stream's sequence on ``model``
(``seq_residual_hybrid``, the dry run's ``--auto`` choice) against a single
process's, at this world's bounds.
"""
import pytest

from test_torch_sharding_dist import assert_seq_residual, check

ARCH, STRATEGY, SWA, LR = "zamba2-7b", "tp", None, (1e-6, 2, 10)
STATE, WINDOW = [4, 2, 4, 16, 32], [4, 3, 320]      # one layer's (B, G, Hg, N, P), (B, K-1, C)


def test_sharded_hybrid_steps_match_single_process_and_jax(tmp_path, monkeypatch):
    out = check(tmp_path, monkeypatch, ARCH, STRATEGY, SWA, LR, grads_rtol=2e-5,
                params_lr=0.5, logits_atol=2e-5, extra="seq_residual_hybrid")
    got, gaps = out["got"], out["gaps"]
    assert got["placement/layers.0.mixer.in_proj"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["placement/layers.0.mixer.conv_w"] == "(Replicate(), Shard(dim=1))"
    assert got["placement/shared_attn.attn.wq"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["placement/cache_ssm_state"] == "(Shard(dim=1), Shard(dim=5))"   # batch, P
    assert got["placement/cache_conv"] == "(Shard(dim=1), Shard(dim=3))"        # batch, channels
    assert got["placement/cache_shared_k"] == "(Shard(dim=1), Shard(dim=2))"    # batch, sequence
    assert got["placement/cache_shared_v"] == "(Shard(dim=1), Shard(dim=2))"
    assert bool(got["state_written_in_place"])
    moves = gaps["comm"]["redistributions"]
    assert not [m for m in moves if m[2] in (STATE, WINDOW)], moves
    assert ["(Shard(dim=0), Shard(dim=2))", "(Shard(dim=0), Replicate())", [4, 1, 320]] in moves
    assert ["(Shard(dim=0), Shard(dim=3))", "(Shard(dim=0), Replicate())",
            [4, 2, 4, 32]] in moves
    # the residual stream's sequence on model, at this world's own bounds
    assert_seq_residual(got, grads_rtol=2e-5, params_lr=0.5, logits_atol=2e-5)


@pytest.mark.parametrize("h0,hl,hg,want", [
    (2, 2, 4, slice(0, 1)),           # zamba2's smoke arch on model 4: part of group 0
    (6, 2, 4, slice(1, 2)),           # ... and of group 1
    (4, 4, 2, slice(2, 4)),           # whole groups 2 and 3
    (0, 8, 4, slice(0, 2)),           # every head (P sharded, or no model axis)
    (8, 8, 12, slice(0, 2)),          # 4 heads of group 0, 4 of group 1: two blocks
    (4, 8, 6, [0, 0, 1, 1, 1, 1, 1, 1]),  # uneven straddle: one group a head
])
def test_local_groups_of_each_layout(h0, hl, hg, want):
    """The B/C columns a rank's heads [h0, h0 + hl) take (``hg`` heads a
    group): a slice when its heads fall into equal blocks of one group
    each, else one group index a head; either way the scan's reshape of
    the heads into (groups, heads a group) pairs each head with its own
    group."""
    from repro_torch.models import mamba2
    got = mamba2._local_groups(h0, hl, hg)
    assert got == want
    groups = got if isinstance(got, list) else list(range(999))[got]
    per = hl // len(groups)
    assert [groups[j // per] for j in range(hl)] == [(h0 + j) // hg for j in range(hl)]
