from ..api.handle import MatchHandle, QueryResult
from ..api.options import MatchOptions
from .query_server import QueryServer

__all__ = ["MatchHandle", "MatchOptions", "QueryResult", "QueryServer"]
