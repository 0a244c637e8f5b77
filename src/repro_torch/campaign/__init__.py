"""Ensemble time-history campaigns (paper §3), one card a process.

The paper's payoff is massive ensemble generation — 100 bedrock waves ×
16,000 steps on the 32.5M-DOF Tokyo model — feeding the NN surrogate.  This
package runs that workload as a *campaign*: rounds of ``kset`` cases
advanced as one native k-set, checkpointed for exact mid-campaign resume,
with remainder case counts padded and masked so any ``n_waves`` works.
Several processes split the case axis (:func:`case_topology`), each on its
own device, and share nothing but barriers; several devices in one process
are not ported.
"""
from repro_torch.campaign.runner import (  # noqa: F401
    CampaignConfig,
    CampaignResult,
    CaseTopology,
    case_topology,
    make_campaign_chunk,
    run_campaign,
)
