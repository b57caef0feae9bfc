from .beamforming import beam_sweep_project, dft_codebook, dft_codebook_ri
from .cdl import CDL_B, CDLDraws, CDLModel, generate_cdl_channel
from .dataset import generate_beamformed_dataset
from .interpolate import interpolate_slots

__all__ = [
    "CDL_B",
    "CDLDraws",
    "CDLModel",
    "generate_cdl_channel",
    "beam_sweep_project",
    "dft_codebook",
    "dft_codebook_ri",
    "generate_beamformed_dataset",
    "interpolate_slots",
]
