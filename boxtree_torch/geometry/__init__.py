from boxtree_torch.geometry.area_query import (
    AreaQueryBuilder,
    AreaQueryResult,
    LeavesToBallsLookup,
    LeavesToBallsLookupBuilder,
    PeerListFinder,
    PeerListLookup,
    SpaceInvaderQueryBuilder,
    area_query_elementwise,
)

__all__ = [
    "AreaQueryBuilder",
    "AreaQueryResult",
    "LeavesToBallsLookup",
    "LeavesToBallsLookupBuilder",
    "PeerListFinder",
    "PeerListLookup",
    "SpaceInvaderQueryBuilder",
    "area_query_elementwise",
]
