"""Fleet-scale training: many CELU-VFL jobs as one batched program.

Port of ``repro/fleet``.  ``scheduler`` re-expresses the pipelined
engine's schedule as one step function per job, with the exchange queue
stacked over a fixed depth, so that ``torch.func.vmap`` batches it over a
leading job axis; ``runner`` partitions a list of :class:`JobSpec` into
cohorts and runs each as one batched program (``mode="vmap"``) or lane by
lane (``mode="map"``).
"""
from .runner import (FleetResult, FleetWorkload, JobSpec, cohort_key,
                     run_fleet)
from .scheduler import (ENGINE_RNG_BASES, FleetRoundState, JobHyper,
                        JobUniforms, average_flush_metrics, make_fleet_step)

__all__ = [
    "ENGINE_RNG_BASES", "FleetResult", "FleetRoundState", "FleetWorkload",
    "JobHyper", "JobSpec", "JobUniforms", "average_flush_metrics",
    "cohort_key", "make_fleet_step", "run_fleet",
]
