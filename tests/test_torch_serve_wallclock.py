"""Wall-clock serving on a multi-rank mesh (``runtime.engine``): rank 0
routes the requests (``submit`` there, broadcast at each step through
``Mesh.broadcast``), every rank calls ``ServingEngine.run()``.

gpt2-moe-smoke on a (1, 2) and a (2, 1) gloo mesh (``_torch_ranks.
wallclock_body``): five requests of 3-12 tokens, each generating 3
tokens under a budget that takes several steps, then a follow-up of the
first (its path state seeded from it).  Every rank returns the same
results (ids, generated tokens, arrivals, completion and first-token
stamps, logits) and ends after the same number of steps; the generated
tokens and the logits are those of ``simulate`` replaying the same
requests; the run records broadcasts over the world; another rank's
wall-clock ``submit`` is refused.  On a (1, 1) mesh, under an engine
clock that counts its calls, every completion and first-token stamp is
the clock's reading at the end of its step (``wallclock_stamp_body``),
as without a mesh, not rank 0's step start plus the timed phases.
"""
import pytest

from _torch_ranks import (WALL_NEW, WALL_PROMPTS, run_ranks, wallclock_body,
                          wallclock_stamp_body)


@pytest.fixture(scope="module", params=[(1, 2), (2, 1)],
                ids=["1x2", "2x1"])
def ranks(request, tmp_path_factory):
    return run_ranks(wallclock_body, 2, tmp_path_factory.mktemp("wall"),
                     request.param)


def test_every_rank_returns_the_same_results(ranks):
    r0 = ranks[0]
    assert [r[0] for r in r0["wall"]] == list(range(len(WALL_PROMPTS)))
    assert [r[0] for r in r0["follow_up"]] == [len(WALL_PROMPTS)]
    assert r0["steps"] > 2
    for r in ranks[1:]:
        for k in ("wall", "follow_up", "steps", "path_state"):
            assert r[k] == r0[k], k
    for rid, n, toks, arrival, done, ttft, _ in r0["wall"]:
        assert n == WALL_PROMPTS[rid] and len(toks) == WALL_NEW
        assert arrival <= ttft <= done


def test_the_tokens_are_simulates(ranks):
    for r in ranks:
        got = [(rid, toks, logits) for rid, _, toks, _, _, _, logits
               in r["wall"]]
        assert got == r["replay"]


def test_the_router_broadcasts_and_other_ranks_refuse_submits(ranks):
    for r in ranks:
        assert ("broadcast", "world") in r["kinds"]
    assert "refused" not in ranks[0]
    assert "rank 0 admits wall-clock requests" in ranks[1]["refused"]


def test_a_one_rank_mesh_stamps_the_end_of_the_step(tmp_path):
    steps = run_ranks(wallclock_stamp_body, 1, tmp_path, (1, 1))[0]
    assert len(steps) > 2
    assert sum(len(stamps) for stamps, _ in steps) == len(WALL_PROMPTS)
    for stamps, last in steps:
        for done, ttft in stamps:
            assert done == last
            assert ttft <= done
