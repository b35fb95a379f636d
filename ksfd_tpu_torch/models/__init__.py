from .ligands import Ligand, LigandGroup, LigandGroups
from .solution_params import SolutionParameters, topological_sort

__all__ = [
    "Ligand",
    "LigandGroup",
    "LigandGroups",
    "SolutionParameters",
    "topological_sort",
]
