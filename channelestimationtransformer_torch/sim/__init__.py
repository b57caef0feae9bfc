"""The end-to-end link simulation (JAX counterpart ``sim/``): QAM, OFDM, ZF
precoding, LS / LMMSE, conv and QC-LDPC FEC, and the Monte-Carlo BER loop.
Stock torch ops: in JAX this is XLA work, with no Pallas kernel."""

from .qam import qam_constellation, qam_demap_hard, qam_llr, qam_map
from .precoding import spectral_efficiency, zf_precoder
from .estimation import lmmse_equalize, ls_estimate
from .link import LinkConfig, simulate_ber, simulate_coded_ber
from .coding import conv_encode, viterbi_decode
from .ldpc import ldpc_decode, ldpc_encode, make_qc_ldpc
from .ofdm import (
    apply_time_channel,
    ofdm_demodulate,
    ofdm_modulate,
    taps_to_frequency_response,
)

__all__ = [
    "qam_constellation",
    "qam_demap_hard",
    "qam_llr",
    "qam_map",
    "spectral_efficiency",
    "zf_precoder",
    "lmmse_equalize",
    "ls_estimate",
    "LinkConfig",
    "simulate_ber",
    "simulate_coded_ber",
    "conv_encode",
    "viterbi_decode",
    "ldpc_decode",
    "ldpc_encode",
    "make_qc_ldpc",
    "apply_time_channel",
    "ofdm_demodulate",
    "ofdm_modulate",
    "taps_to_frequency_response",
]
