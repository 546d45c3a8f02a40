from .ddim import DDIMSampler, ddim_sample, ddim_timestep_grid
from .ddpm import ddpm_sample
from .dpm import DPMSolverPP, dpmpp_coefficients, dpmpp_sample
from .schedule import NoiseSchedule

SAMPLERS = ("ddim", "ddim_std", "dpmpp")


def make_sampler(name: str, sched: NoiseSchedule, eta: float = 0.0):
    """``ddim`` is the reference-parity sampler, ``ddim_std`` textbook
    strided DDIM; both take any eta. ``dpmpp`` is DPM-Solver++(2M),
    deterministic, so its eta must be 0. Ancestral DDPM (``ddpm_sample``,
    all T steps) is not among them, as in JAX."""
    if name == "ddim":
        return DDIMSampler(sched, eta=eta)
    if name == "ddim_std":
        return DDIMSampler(sched, eta=eta, standard=True)
    if name == "dpmpp":
        if eta != 0.0:
            raise ValueError("DPM-Solver++ is deterministic: eta must be 0.0 "
                             "(use sampler='ddim' for eta > 0)")
        return DPMSolverPP(sched)
    raise ValueError(f"unknown sampler {name!r}; choose from {SAMPLERS}")


__all__ = ["NoiseSchedule", "DDIMSampler", "ddim_sample", "ddim_timestep_grid", "ddpm_sample",
           "DPMSolverPP", "dpmpp_coefficients", "dpmpp_sample", "SAMPLERS", "make_sampler"]
