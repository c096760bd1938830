"""Quickstart on the PyTorch port: match a query graph in a data graph
with dead-end pruning (twin of ``examples/quickstart.py``). The wave
engine runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Each part is a function that prints its line and returns its numbers,
so that tests and ``chip_smoke.py`` check values, not text.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch.core.backtrack import backtrack_deadend
from repro_torch.core.graph import Graph
from repro_torch.core.vectorized import match_vectorized
from repro_torch.data.graph_gen import (random_walk_query, trap_graph,
                                        yeast_like_graph)


def paper_example() -> dict:
    """The paper's Fig. 1 example. Labels: a=0, b=1, c=2; the query is
    the path a-b-c-a."""
    query = Graph.from_edges(4, [(0, 1), (1, 2), (2, 3)], [0, 1, 2, 0])
    data = Graph.from_edges(
        7, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (4, 5), (5, 6)],
        [0, 1, 2, 0, 1, 2, 0])
    res = backtrack_deadend(query, data, limit=None)
    print(f"paper-style example: {res.stats.found} embeddings, "
          f"{res.stats.recursions} recursions")
    for e in res.embeddings:
        print("  embedding:", {f"u{i+1}": f"v{v+1}"
                               for i, v in enumerate(e.tolist())})
    return {"found": res.stats.found, "recursions": res.stats.recursions,
            "embeddings": [e.tolist() for e in res.embeddings]}


def trap_pruning(n: int = 100) -> dict:
    """Dead-end pruning at work on trap(n x n): quadratic -> linear."""
    q, g = trap_graph(n_b=n, n_c=n, n_good=2, tail_len=2)
    pruned = backtrack_deadend(q, g, limit=None)
    plain = backtrack_deadend(q, g, limit=None, use_pruning=False)
    print(f"\ntrap({n}x{n}): pruned={pruned.stats.recursions} recursions "
          f"vs no-pruning={plain.stats.recursions} "
          f"({plain.stats.recursions / pruned.stats.recursions:.1f}x), "
          f"same {pruned.stats.found} embeddings")
    return {"query": q, "data": g, "found": pruned.stats.found,
            "pruned_recursions": pruned.stats.recursions,
            "plain_recursions": plain.stats.recursions,
            "plain_found": plain.stats.found}


def wave_engine(q, g, want_found: int, device="cuda") -> dict:
    """The wave engine on the same trap: the same embeddings, found by
    vectorized waves on ``device``."""
    eng = match_vectorized(q, g, device=device, limit=None, wave_size=256,
                           kpr=16)
    assert eng.stats.found == want_found, (eng.stats.found, want_found)
    print(f"wave engine: {eng.stats.found} embeddings in "
          f"{eng.stats.waves} waves, {eng.stats.rows_created} rows, "
          f"{eng.stats.deadend_prunes} dead-end prunes")
    return {"found": eng.stats.found, "waves": eng.stats.waves,
            "rows": eng.stats.rows_created,
            "prunes": eng.stats.deadend_prunes,
            "embeddings": eng.embeddings}


def yeast_query() -> dict:
    """A 12-vertex walk query on a graph of the paper's yeast size."""
    big = yeast_like_graph(0)
    qq = random_walk_query(big, 12, seed=5)
    r = backtrack_deadend(qq, big, limit=1000)
    print(f"\nyeast-like |V|={big.n}: 12-vertex query -> "
          f"{r.stats.found} embeddings in {r.stats.wall_time_s*1e3:.1f} ms")
    return {"n_vertices": big.n, "found": r.stats.found,
            "recursions": r.stats.recursions}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    device = ap.parse_args(argv).device
    fig1 = paper_example()
    trap = trap_pruning()
    eng = wave_engine(trap["query"], trap["data"], trap["found"], device)
    return {"fig1": fig1, "trap": trap, "engine": eng,
            "yeast": yeast_query()}


if __name__ == "__main__":
    main()
