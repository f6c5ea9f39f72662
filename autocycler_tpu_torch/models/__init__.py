from .position import Position, PositionArray
from .sequence import Sequence
from .unitig import Unitig, UnitigStrand, UnitigType
from .unitig_graph import UnitigGraph
