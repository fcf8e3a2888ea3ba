"""The multi-turn session drive of the prefix-sharing tests, shared by
tests/test_torch_prefix_sharing.py (the port and the reference on the
CPU) and tests/test_torch_gpu.py (the port on the card).  It imports no
JAX: it takes the engine and its package's ``serving`` module."""

import numpy as np


def session_drive(eng, serving, vocab: int, *, turns: int = 3):
    """Two tenants with a 32-token system prompt, two sessions each,
    ``turns`` closed waves of greedy requests: turn t + 1's prompt is turn
    t's prompt, its output and a few new tokens, so it adopts blocks that
    turn t released into the cached tier.  Run on an engine whose budget
    is tight, the scheduler preempts requests that hold adopted blocks.

    Returns (streams, counts): the blocks adopted from the cached tier
    (refcount 0 when adopted), and the preemptions and swap outs of
    requests holding adopted blocks."""
    counts = {"cached_adopted": 0, "adopted_preempts": 0,
              "adopted_swaps": 0}
    preempt, adopt = eng._preempt, eng.kv.allocate_shared

    def counted_preempt(r):
        held = eng.kv.holds(r.request_id) \
            and eng.kv.adopted_blocks_of(r.request_id) > 0
        before = eng.metrics.swap_outs
        preempt(r)
        if held:
            counts["adopted_preempts"] += 1
            counts["adopted_swaps"] += eng.metrics.swap_outs - before

    def counted_adopt(rid, ctx_len, blocks, hashes):
        counts["cached_adopted"] += sum(eng.kv.refcount_of(b) == 0
                                        for b in blocks)
        return adopt(rid, ctx_len, blocks, hashes)

    eng._preempt, eng.kv.allocate_shared = counted_preempt, counted_adopt
    rng = np.random.default_rng(4)
    systems = [[int(t) for t in rng.integers(3, vocab, 32)]
               for _ in range(2)]
    prompts = {(t, s): systems[t] + [int(x) for x in rng.integers(
        3, vocab, int(rng.integers(4, 12)))]
        for t in range(2) for s in range(2)}
    streams = []
    for turn in range(turns):
        reqs = {key: serving.ServeRequest(
            f"t{key[0]}s{key[1]}u{turn}", f"tenant {key[0]}", list(p),
            max_new_tokens=int(rng.integers(6, 12)), temperature=0.0,
            eos_token=-1, tenant=f"t{key[0]}",
            session_id=f"t{key[0]}s{key[1]}")
            for key, p in prompts.items()}
        eng.submit_batch(list(reqs.values()))
        eng.run_until_done(max_steps=5000)
        for key, r in reqs.items():
            assert r.state == serving.RequestState.FINISHED
            streams.append(r.output_tokens)
            prompts[key] = r.prompt_tokens + r.output_tokens + [
                int(x) for x in rng.integers(3, vocab,
                                             int(rng.integers(4, 10)))]
    return streams, counts
