"""Ensemble time-history campaigns (paper §3) over a case mesh.

The paper's payoff is massive ensemble generation — 100 bedrock waves ×
16,000 steps on the 32.5M-DOF Tokyo model — feeding the NN surrogate.  This
package runs that workload as a *campaign*: rounds of ``kset`` cases
advanced as one native k-set, checkpointed for exact mid-campaign resume,
with remainder case counts padded and masked so any ``n_waves`` works.
Several processes split the case axis (:func:`case_topology`) and share
nothing but barriers; each runs the entries of the case mesh it owns
(``launch.mesh.make_case_mesh``: one or several cards, or CPU entries), an
entry a host thread and a CUDA stream, one k-set carry an entry.
"""
from repro_torch.campaign.runner import (  # noqa: F401
    CampaignConfig,
    CampaignResult,
    CaseTopology,
    case_topology,
    make_campaign_chunk,
    run_campaign,
)
