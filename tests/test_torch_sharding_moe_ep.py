"""The sharded steps of qwen3-moe-30b-a3b's smoke arch (2 layers, d 128, 8
experts top-2 of 64, renormalised top-k, f32) under ``moe_strategy="ep"``
over 8 gloo ranks on a ``(2, 4)`` ``data × model`` mesh: the 8 experts
sharded 2 a rank over ``model``, held against the port's single-process
steps and JAX's by ``tests/test_torch_sharding_dist.py`` (see its docstring for
every check and bound). Here also: the expert weights and the dispatch
buffer sharded on the expert dim, and the combine's all-gather of the
experts' output over ``model`` (the collective GSPMD's all-to-all is
replaced by) as ``CommDebugMode`` saw it in one MoE layer.
And the steps with the residual stream's sequence on ``model``
(``seq_residual_moe``, the dry run's ``--auto`` choice) against a single
process's.
"""
from test_torch_sharding_dist import assert_seq_residual, check

ARCH, STRATEGY, SWA, LR = "qwen3-moe-30b-a3b", "ep", None, (1e-6, 2, 10)


def test_sharded_moe_ep_steps_match_single_process_and_jax(tmp_path, monkeypatch):
    out = check(tmp_path, monkeypatch, ARCH, STRATEGY, SWA, LR, extra="seq_residual_moe")
    got, gaps = out["got"], out["gaps"]
    # experts on model, the FSDP embed dim on data
    assert got["placement/layers.0.moe.w_gate"] == "(Shard(dim=1), Shard(dim=0))"
    assert got["placement/layers.0.moe.w_down"] == "(Shard(dim=2), Shard(dim=0))"
    # the expert weights' FSDP gather before use reduce-scatters their
    # gradients in its backward, so they come back in their own placements;
    # the router's comes back a Partial sum, which the step redistributes
    assert not {"layers.0.moe.w_gate", "layers.0.moe.w_up", "layers.0.moe.w_down"} & set(
        gaps["grads_in_other_placements"])
    assert got["raw_grad/layers.0.moe.router"] == "(Partial(sum), Partial(sum))"
    assert got["placement/cache_k"] == "(Shard(dim=1), Shard(dim=2))"     # batch, sequence
    # the combine takes every expert's rows back: the (B, E, C, D) output
    # buffer from experts on model to whole, an all-gather over model
    moves = gaps["comm"]["redistributions"]
    assert ["(Shard(dim=0), Shard(dim=1))", "(Shard(dim=0), Replicate())",
            [4, 8, 1, 128]] in moves, moves
    assert gaps["comm"]["counts"].get("c10d_functional.all_gather_into_tensor", 0) >= 1
    assert_seq_residual(got)     # the residual stream's sequence on model
