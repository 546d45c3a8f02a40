from .ddim import DDIMSampler, ddim_sample, ddim_timestep_grid
from .schedule import NoiseSchedule

SAMPLERS = ("ddim", "ddim_std")


def make_sampler(name: str, sched: NoiseSchedule, eta: float = 0.0) -> DDIMSampler:
    """``ddim`` is the reference-parity sampler, ``ddim_std`` textbook
    strided DDIM; both take any eta."""
    if name == "ddim":
        return DDIMSampler(sched, eta=eta)
    if name == "ddim_std":
        return DDIMSampler(sched, eta=eta, standard=True)
    raise ValueError(f"unknown sampler {name!r}; choose from {SAMPLERS}")


__all__ = ["NoiseSchedule", "DDIMSampler", "ddim_sample", "ddim_timestep_grid",
           "SAMPLERS", "make_sampler"]
