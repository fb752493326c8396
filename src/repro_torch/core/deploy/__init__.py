"""The deployment layer, in part: the two modules the static analysis
reads recorded search outputs with.

* :class:`ParetoFront` — load any recorded search output and
  :meth:`~ParetoFront.select` under a constraint (the paper's "fastest
  variant within a 2% accuracy relaxation" as code);
* :class:`ArtifactRegistry` / :class:`Artifact` — fingerprinted, atomically
  written winner manifests keyed by ``(kind, name, shape)``, with
  byte-exact round-trips and verified resolution.

The serving engine, the KV plan, the router and the ``python -m`` CLI of
the reference's deployment layer are later work (ROADMAP.md, queue 1).
"""

from .front import FrontMember, ParetoFront
from .registry import Artifact, ArtifactRegistry, shape_tag

__all__ = ["ParetoFront", "FrontMember",
           "Artifact", "ArtifactRegistry", "shape_tag"]
