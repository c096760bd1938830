from .graph_gen import (ba_labeled_graph, er_labeled_graph,
                        human_like_graph, powerlaw_graph, random_walk_query,
                        yeast_like_graph)

__all__ = ["ba_labeled_graph", "er_labeled_graph", "human_like_graph",
           "powerlaw_graph", "random_walk_query", "yeast_like_graph"]
