"""Campaign engine: whole parameter sweeps, one stacked drain per point.

Port of ``repro/campaign``.  A *campaign* is a grid of model-parameter
points × a set of replication seeds.  Each point builds its own model and
engine; within a point every seed is data, and all of them advance
together through :meth:`ParsirEngine.run_replicated_drained`: two
dispatches per point (the ingest and the drain), whatever the seed count.

Modules:
  * :mod:`repro_torch.campaign.spec`   — :class:`CampaignSpec`, the
    declarative grid, canonically digestible (the reference's copy);
  * :mod:`repro_torch.campaign.store`  — :class:`ResultsStore`, one JSON
    per grid point under a digest-keyed run directory (the reference's
    copy);
  * :mod:`repro_torch.campaign.runner` — :func:`run_campaign`.

The CLI face is :mod:`repro_torch.launch.campaign`.
"""
from .spec import CampaignSpec
from .store import ResultsStore
from .runner import run_campaign

__all__ = ["CampaignSpec", "ResultsStore", "run_campaign"]
