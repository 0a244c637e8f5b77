"""Surrogate side of the port: the campaign's dataset shards, the CNN+LSTM
and SSM trajectory surrogates, and their trainer."""
from repro_torch.surrogate.dataset import ShardStream, load_shards, plan_scenario_order, save_shards
from repro_torch.surrogate.model import SurrogateConfig
from repro_torch.surrogate.seqmodel import TrajectoryConfig
from repro_torch.surrogate.train import fit, fit_shards, fit_stream, load_surrogate, save_surrogate, search
from repro_torch.surrogate.trajectory import (
    fit_trajectory, fit_trajectory_shards, fit_trajectory_stream, load_trajectory, save_trajectory,
)

__all__ = [
    "ShardStream", "SurrogateConfig", "TrajectoryConfig", "fit", "fit_shards", "fit_stream",
    "fit_trajectory", "fit_trajectory_shards", "fit_trajectory_stream", "load_shards", "load_surrogate",
    "load_trajectory", "plan_scenario_order", "save_shards", "save_surrogate", "save_trajectory", "search",
]
