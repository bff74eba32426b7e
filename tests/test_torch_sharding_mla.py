"""The sharded steps of minicpm3-4b's smoke arch (2 layers, d 128, 4 heads,
q_lora 64, kv_lora 32, nope 16, rope 16, v 32, f32) over 8 gloo ranks on a
``(2, 4)`` ``data × model`` mesh, held against the port's single-process
steps and JAX's by ``tests/test_torch_sharding_dist.py`` (see its docstring for
every check and bound). Here also: the latent cache (c_kv, k_rope) in
``cache_shardings`` (its sequence on ``model``), and the collectives of one
absorbed decode as ``CommDebugMode`` saw them: the absorbed query's heads
gathered, and the max, the sum and the partial ``ctx_lat`` (B, 1, H, r)
reduced over ``model``; neither the cache nor the scores over its 36
positions moved.

And heads that do not divide ``model`` (``uneven_mla``: the smoke arch at 6
heads, as minicpm3-4b's 40 on the dry run's ``model`` of 16): on a
``model`` axis of 4 ``torch.chunk`` gives the ranks 2, 2, 2 and 0 heads.
q, ``wuk``/``wuv`` and their products are made whole before their heads
are split (``attention.split_heads``) and merged (``merge_heads``); the
prefill, 2 decode steps and a train step are held against a single
process's at the audio world's ``uneven_whisper`` bounds.
"""
import json

from test_torch_sharding_dist import check

ARCH, STRATEGY, SWA, LR = "minicpm3-4b", "tp", None, (1e-2, 2, 10)


def test_sharded_mla_steps_match_single_process_and_jax(tmp_path, monkeypatch):
    out = check(tmp_path, monkeypatch, ARCH, STRATEGY, SWA, LR, extra="uneven_mla")
    got, gaps = out["got"], out["gaps"]
    assert got["placement/layers.0.attn.wdkv"] == "(Shard(dim=0), Shard(dim=1))"  # FSDP, lora
    assert got["placement/cache_c_kv"] == "(Shard(dim=1), Shard(dim=2))"          # batch, sequence
    assert got["placement/cache_k_rope"] == "(Shard(dim=1), Shard(dim=2))"
    moves = gaps["comm"]["redistributions"]
    # q_lat (B, 1, H, r) and q_rope made whole on their heads
    assert ["(Shard(dim=0), Shard(dim=2))", "(Shard(dim=0), Replicate())",
            [4, 1, 4, 32]] in moves, moves
    # the softmax's max and sum reduced over the sequence's shards, and
    # ctx_lat's partial sum (DTensor reduce-scatters it onto the heads)
    assert ["(Shard(dim=0), Partial(max))", "(Shard(dim=0), Replicate())",
            [4, 4, 1, 1]] in moves, moves
    assert any(src.endswith("Partial(sum))") and shape[-1] == 32 for src, _, shape in moves)
    # nothing over the 36 positions moved but the (36,) mask, sliced locally
    assert all(shape == [36] for _, _, shape in moves if 36 in shape), moves
    # 6 heads on a model axis of 4 (2, 2, 2 and 0 a rank)
    uneven = json.loads(str(got["uneven_mla"]))
    print("uneven_mla", uneven)
    assert uneven["prefill"] <= 1e-5 and uneven["tokens_equal"]
    assert uneven["loss_rel"] <= 1e-5 and uneven["grads_rel"] <= 1e-5
    assert uneven["params_lr"] <= 0.1
