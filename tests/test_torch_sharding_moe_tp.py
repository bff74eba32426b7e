"""The sharded steps of mixtral-8x7b's smoke arch (2 layers, d 128, 8
experts top-2 of 64, f32) with a sliding window of 16 under
``moe_strategy="tp"`` over 8 gloo ranks on a ``(2, 4)`` ``data × model``
mesh, held against the port's single-process steps and JAX's by
``tests/test_torch_sharding_dist.py`` (see its docstring for every check and
bound). The smoke arch keeps the published window of 4 096, which 32 + 4
positions never reach; at 16 the decode's window mask picks global
positions out of a cache whose sequence is sharded over ``model`` (and
JAX's step is built with the same window). Here also: every expert whole
on each rank and its ``expert_ff`` dim sharded over ``model``, so the
combine reduces the partial sums of the experts' output.
"""
from test_torch_sharding_dist import check

ARCH, STRATEGY, SWA, LR = "mixtral-8x7b", "tp", 16, (1e-6, 2, 10)


def test_sharded_moe_tp_steps_match_single_process_and_jax(tmp_path, monkeypatch):
    out = check(tmp_path, monkeypatch, ARCH, STRATEGY, SWA, LR)
    got, gaps = out["got"], out["gaps"]
    # expert_ff on model, the FSDP embed dim on data, the experts whole
    assert got["placement/layers.0.moe.w_gate"] == "(Shard(dim=1), Shard(dim=2))"
    assert got["placement/layers.0.moe.w_down"] == "(Shard(dim=2), Shard(dim=1))"
    # the expert weights' FSDP gather before use reduce-scatters their
    # gradients in its backward, so they come back in their own placements;
    # the router's comes back a Partial sum, which the step redistributes
    assert not {"layers.0.moe.w_gate", "layers.0.moe.w_up", "layers.0.moe.w_down"} & set(
        gaps["grads_in_other_placements"])
    assert got["raw_grad/layers.0.moe.router"] == "(Partial(sum), Partial(sum))"
    assert got["placement/cache_k"] == "(Shard(dim=1), Shard(dim=2))"     # batch, sequence
    # the combine reduces the experts' output, a partial sum over model
    moves = gaps["comm"]["redistributions"]
    assert ["(Shard(dim=0), Partial(sum))", "(Shard(dim=0), Replicate())",
            [4, 8, 1, 128]] in moves, moves
    assert gaps["comm"]["counts"].get("c10d_functional.all_reduce", 0) >= 1
