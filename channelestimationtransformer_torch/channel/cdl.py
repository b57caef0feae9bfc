"""3GPP TR 38.901 CDL channel simulator (JAX counterpart ``channel/cdl.py``).

Replaces the reference's Sionna stage (``GenerateDatasets/
GenerateChannelsFreqPreMatlab.py:37-121``: CDL-B, 28 GHz, BS 64-element ULA
with the 38.901 element pattern, UE omni ULA, downlink, one sample per slot,
a single subcarrier, so one frequency-flat channel matrix per slot).

TR 38.901 §7.7.1 step by step: per-cluster delays, powers and angles from
the CDL table, 20 rays per cluster at the Table 7.5-3 offsets scaled by the
cluster spreads, random ray coupling and initial phases, plane-wave array
responses of the two ULAs, and per-ray Doppler from a random in-plane UE
velocity. Single (vertical) polarization.

The arithmetic is float32 as in JAX, op for op where it matters: the angle
tables become float32 before the offsets are added, ``t = arange(T) / fs``
is a float32 division, and every phase is formed in the JAX package's
order. The four random draws of a batch (:class:`CDLDraws`) come from a
``torch.Generator`` or are injected, so a test can feed JAX's own draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.runtime import full_f32_matmul, resolve_device

SPEED_OF_LIGHT = 299_792_458.0

# TR 38.901 Table 7.5-3: offset angles of the 20 rays within a cluster.
RAY_OFFSETS = np.array(
    [
        0.0447, -0.0447, 0.1413, -0.1413, 0.2492, -0.2492, 0.3715, -0.3715,
        0.5129, -0.5129, 0.6797, -0.6797, 0.8844, -0.8844, 1.1481, -1.1481,
        1.5195, -1.5195, 2.1551, -2.1551,
    ]
)


@dataclasses.dataclass(frozen=True, eq=False)
class CDLTable:
    """One CDL profile: per-cluster normalized delay, power (dB), and mean
    angles (degrees), plus per-cluster ray spreads (TR 38.901 Table 7.7.1-x).
    Hash and equality by profile name."""

    name: str
    delays: np.ndarray  # [N] normalized delay
    powers_db: np.ndarray  # [N]
    aod: np.ndarray  # [N] azimuth of departure, deg
    aoa: np.ndarray  # [N] azimuth of arrival, deg
    zod: np.ndarray  # [N] zenith of departure, deg
    zoa: np.ndarray  # [N] zenith of arrival, deg
    c_asd: float  # deg
    c_asa: float
    c_zsd: float
    c_zsa: float

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, CDLTable) and self.name == other.name


# TR 38.901 Table 7.7.1-2: CDL-B (NLOS), 23 clusters.
CDL_B = CDLTable(
    name="CDL-B",
    delays=np.array([
        0.0000, 0.1072, 0.2155, 0.2095, 0.2870, 0.2986, 0.3752, 0.5055,
        0.3681, 0.3697, 0.5700, 0.5283, 1.1021, 1.2756, 1.5474, 1.7842,
        2.0169, 2.8294, 3.0219, 3.6187, 4.1067, 4.2790, 4.7834,
    ]),
    powers_db=np.array([
        0.0, -2.2, -4.0, -3.2, -9.8, -1.2, -3.4, -5.2, -7.6, -3.0, -8.9,
        -9.0, -4.8, -5.7, -7.5, -1.9, -7.6, -12.2, -9.8, -11.4, -14.9,
        -9.2, -11.3,
    ]),
    aod=np.array([
        9.3, 9.3, 9.3, -34.1, -65.4, -11.4, -11.4, -11.4, -67.2, 52.5,
        -72.0, 74.3, -52.2, -50.5, 61.4, 30.6, -72.5, -90.6, -77.6, -82.6,
        -103.6, 75.6, -77.6,
    ]),
    aoa=np.array([
        -173.3, -173.3, -173.3, 125.5, -88.0, 155.1, 155.1, 155.1, -89.8,
        132.1, -83.6, 95.3, 103.7, -87.8, -92.5, -139.1, -90.6, 58.6,
        -79.0, 65.8, 52.7, 88.7, -60.3,
    ]),
    zod=np.array([
        105.8, 105.8, 105.8, 115.3, 119.3, 103.2, 103.2, 103.2, 118.2,
        102.0, 100.4, 98.3, 103.4, 102.5, 101.4, 103.0, 100.0, 115.2,
        100.5, 119.6, 118.7, 117.8, 115.7,
    ]),
    zoa=np.array([
        78.9, 78.9, 78.9, 63.3, 59.9, 67.5, 67.5, 67.5, 82.6, 66.3, 61.6,
        58.0, 78.2, 82.0, 62.4, 78.0, 60.9, 82.9, 60.8, 57.3, 59.9, 60.1,
        62.3,
    ]),
    c_asd=10.0,
    c_asa=22.0,
    c_zsd=3.0,
    c_zsa=7.0,
)


def _element_pattern_38901_db(zenith_deg, azimuth_deg):
    """TR 38.901 §7.3 BS element power pattern (dB), 8 dBi max gain."""
    a_v = -torch.clamp(12.0 * ((zenith_deg - 90.0) / 65.0) ** 2, max=30.0)
    a_h = -torch.clamp(12.0 * (azimuth_deg / 65.0) ** 2, max=30.0)
    return 8.0 - torch.clamp(-(a_v + a_h), max=30.0)


def _unit_direction(zenith_deg, azimuth_deg):
    """Spherical unit vector (TR 38.901 eq. 7.1-6)."""
    th = torch.deg2rad(zenith_deg)
    ph = torch.deg2rad(azimuth_deg)
    return torch.stack(
        [torch.sin(th) * torch.cos(ph), torch.sin(th) * torch.sin(ph), torch.cos(th)], dim=-1)


def _ula_positions(num_elements: int, spacing_wavelengths: float) -> np.ndarray:
    """Element positions (in wavelengths) of a y-axis ULA, like Sionna's
    ``AntennaArray(num_rows=1, num_cols=N)`` with lambda/2 spacing."""
    idx = np.arange(num_elements) - (num_elements - 1) / 2
    pos = np.zeros((num_elements, 3))
    pos[:, 1] = idx * spacing_wavelengths
    return pos


@dataclasses.dataclass(frozen=True)
class CDLModel:
    """A configured CDL link: geometry + mobility, ready to sample.

    Defaults replicate the reference generation setup
    (``GenerateChannelsFreqPreMatlab.py:57-106``).
    """

    table: CDLTable = CDL_B
    carrier_frequency: float = 28e9
    delay_spread: float = 100e-9
    num_bs_ant: int = 64
    num_ut_ant: int = 2
    ue_speed_ms: float = 30.0 / 3.6
    sampling_frequency: float = 1.0 / (75 * (1 / 120e3 + 0.0))  # 75 symbols @ 120 kHz
    num_rays: int = 20
    bs_pattern_38901: bool = True

    @property
    def wavelength(self) -> float:
        return SPEED_OF_LIGHT / self.carrier_frequency

    @staticmethod
    def calibrated(ue_speed_kmh: float = 5.5) -> "CDLModel":
        """The parity-calibrated configuration (JAX ``CDLModel.calibrated``,
        DESIGN.md §NMSE parity).

        The reference's committed generator (75-symbol slots, 1.6 kHz) has
        normalized Doppler fd*T = 0.49 at its nominal 30 km/h: slot to slot
        decorrelated, and inconsistent with the committed training logs.
        Calibrated from the two observables the reference left: the slot
        period of its stored ``channel.pickle`` (14 OFDM symbols of a
        (16 + 6) / 1.92 MHz grid: 160.42 us), and the UE speed that fits
        its SNR-sweep table through the ensemble Wiener bound (~5.5 km/h;
        30 km/h is ~8 dB off, ``experiments/calibrate_channel.py``).
        """
        slot_period = 14.0 * (16 + 6) / (16 * 120e3)  # 160.42 us
        return CDLModel(sampling_frequency=1.0 / slot_period, ue_speed_ms=ue_speed_kmh / 3.6)


def add_channel_args(parser) -> None:
    """Register the shared channel-selection CLI flags on an argparse parser."""
    parser.add_argument(
        "--slot-symbols", type=int, default=75,
        help="OFDM symbols per sampled slot. 75 = the committed reference "
             "generator (GenerateChannelsFreqPreMatlab.py:44); ignored with "
             "--calibrated")
    parser.add_argument(
        "--ue-speed-kmh", type=float, default=None,
        help="UE mobility (committed reference config: 30). Defaults to 30, "
             "or to the fitted 5.5 km/h under --calibrated")
    parser.add_argument(
        "--calibrated", action="store_true",
        help="use CDLModel.calibrated(): slot period 160.42 us (the stored "
             "channel.pickle geometry) + fitted UE speed, the NMSE-parity "
             "configuration (see experiments/calibrate_channel.py)")


def cdl_from_args(args) -> CDLModel:
    """The CDLModel a driver asked for (see :func:`add_channel_args`)."""
    if getattr(args, "calibrated", False):
        v = args.ue_speed_kmh if getattr(args, "ue_speed_kmh", None) else 5.5
        return CDLModel.calibrated(ue_speed_kmh=v)
    v = args.ue_speed_kmh if getattr(args, "ue_speed_kmh", None) else 30.0
    return CDLModel(
        sampling_frequency=120e3 / getattr(args, "slot_symbols", 75),
        ue_speed_ms=v / 3.6,
    )


@dataclasses.dataclass(frozen=True)
class CDLDraws:
    """The random draws of one batch of :func:`generate_cdl_channel`.

    ``perm_a`` and ``perm_z`` (int64 ``[B, N, M]``) permute each cluster's
    arrival rays in azimuth and in zenith (38.901 step 8, random coupling);
    ``phases`` (float32 ``[B, N, M]``) are the initial ray phases in
    [-pi, pi); ``vel_az`` (float32 ``[B]``) is the UE's travel direction in
    the x-y plane, in [0, 2 pi).
    """

    perm_a: torch.Tensor
    perm_z: torch.Tensor
    phases: torch.Tensor
    vel_az: torch.Tensor

    @classmethod
    def sample(cls, model: CDLModel, batch_size: int, generator: torch.Generator,
               device=None) -> "CDLDraws":
        """Draw a batch's randomness from ``generator`` (on ``device``). A
        permutation is the argsort of float64 uniforms, all of them in one
        call (ties, which would make the order depend on the sort, have a
        chance near 2^-53)."""
        device = resolve_device(device)
        shape = (batch_size, len(model.table.delays), model.num_rays)

        def perm():
            u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
            return torch.argsort(u, dim=-1, stable=True)

        perm_a, perm_z = perm(), perm()
        phases = torch.rand(shape, generator=generator, device=device) * (2 * math.pi) - math.pi
        vel_az = torch.rand((batch_size,), generator=generator, device=device) * (2 * math.pi)
        return cls(perm_a=perm_a, perm_z=perm_z, phases=phases, vel_az=vel_az)

    def to(self, device) -> "CDLDraws":
        return CDLDraws(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def generate_cdl_channel(model: CDLModel, batch_size: int, num_slots: int, *,
                         generator: torch.Generator | None = None, device=None,
                         draws: CDLDraws | None = None) -> torch.Tensor:
    """Sample the frequency-flat per-slot MIMO channel on ``device`` (default:
    the card; raises without one).

    Returns float32 ``[batch, num_slots, num_ut_ant, num_bs_ant, 2]`` (re/im
    pairs): the downlink channel (UE receives), the ``[Rx, Tx]`` matrix the
    reference's MATLAB beam sweep consumes, with unit mean energy per
    sample. With ``draws`` the output is a function of them alone; without,
    they come from ``generator`` (on ``device``).
    """
    device = resolve_device(device)
    tbl = model.table
    n_clusters, n_rays = len(tbl.delays), model.num_rays
    shape = (batch_size, n_clusters, n_rays)
    if draws is None:
        if generator is None:
            raise ValueError("generate_cdl_channel needs a torch.Generator or draws=")
        draws = CDLDraws.sample(model, batch_size, generator, device)
    if tuple(draws.phases.shape) != shape or tuple(draws.vel_az.shape) != (batch_size,):
        raise ValueError(f"draws of shape {tuple(draws.phases.shape)} for a batch of {shape}")
    draws = draws.to(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731

    powers = 10.0 ** (f32(tbl.powers_db) / 10.0)
    powers = powers / torch.sum(powers)

    # Ray angles: cluster mean + spread * offset (deg), float32 tables. [N, M]
    offs = f32(RAY_OFFSETS[:n_rays])
    aod = f32(tbl.aod)[:, None] + tbl.c_asd * offs[None, :]
    aoa = f32(tbl.aoa)[:, None] + tbl.c_asa * offs[None, :]
    zod = f32(tbl.zod)[:, None] + tbl.c_zsd * offs[None, :]
    zoa = f32(tbl.zoa)[:, None] + tbl.c_zsa * offs[None, :]

    # Random coupling: arrival rays permuted per batch sample and cluster.
    aoa_b = torch.gather(aoa.expand(shape), -1, draws.perm_a)
    zoa_b = torch.gather(zoa.expand(shape), -1, draws.perm_z)
    aod_b, zod_b = aod.expand(shape), zod.expand(shape)

    # Array responses. Positions in wavelengths -> phase = 2*pi * (r_hat . pos).
    bs_pos = f32(_ula_positions(model.num_bs_ant, 0.5))  # [S, 3]
    ue_pos = f32(_ula_positions(model.num_ut_ant, 0.5))  # [U, 3]
    r_tx = _unit_direction(zod_b, aod_b)  # [B, N, M, 3]
    r_rx = _unit_direction(zoa_b, aoa_b)

    def phasor(phase):  # exp(1j * phase), as XLA computes it for a real phase
        return torch.complex(torch.cos(phase), torch.sin(phase))

    # TF32 stays off for every product here (the JAX package's XLA dots are
    # float32; so are torch's by default, and this makes sure of it).
    with full_f32_matmul():
        a_tx = phasor(2 * math.pi * torch.einsum("bnmk,sk->bnms", r_tx, bs_pos))  # [B, N, M, S]
        a_rx = phasor(2 * math.pi * torch.einsum("bnmk,uk->bnmu", r_rx, ue_pos))  # [B, N, M, U]

        # BS element pattern (field amplitude); UE is omni.
        if model.bs_pattern_38901:
            gain_db = _element_pattern_38901_db(zod_b, aod_b)
            a_tx = a_tx * (10.0 ** (gain_db / 20.0))[..., None]

        # Doppler: random UE travel direction in the x-y plane. The velocity
        # has no z part, so the 3-term dot product is exact in any order; the
        # division is by a float32 tensor, a true division on every device.
        vel_az = draws.vel_az
        vel = model.ue_speed_ms * torch.stack(
            [torch.cos(vel_az), torch.sin(vel_az), torch.zeros_like(vel_az)], dim=-1)  # [B, 3]
        doppler = (r_rx * vel[:, None, None, :]).sum(-1) / f32(model.wavelength)  # Hz

        t = f32(np.arange(num_slots, dtype=np.float32)
                / np.float32(model.sampling_frequency))  # [T]
        ray_phasor = phasor(draws.phases[..., None] + 2 * math.pi * doppler[..., None] * t)

        amp = torch.sqrt(powers / n_rays)[:, None].expand(n_clusters, n_rays)  # [N, M]

        # h[b, t, u, s] = sum_{n,m} amp * ray_phasor * a_rx * a_tx, factored as
        # one complex matmul over the flattened (cluster, ray) axis K = N*M:
        # P[b, K, t] x A[b, K, u*s] -> [b, t, u*s]. The largest intermediate
        # stays O(B*K*max(T, U*S)), not the O(B*K*T*U*S) of a naive order.
        k = n_clusters * n_rays
        p = (amp[None, :, :, None] * ray_phasor).reshape(batch_size, k, num_slots)
        steer = (a_rx[..., :, None] * a_tx[..., None, :]).reshape(
            batch_size, k, model.num_ut_ant * model.num_bs_ant)
        h = torch.matmul(p.transpose(1, 2), steer).reshape(
            batch_size, num_slots, model.num_ut_ant, model.num_bs_ant)

    # Per-sample energy normalisation (Sionna cir_to_ofdm_channel normalize=
    # True: unit mean energy per resource element over rx, tx and time).
    energy = torch.mean(torch.abs(h) ** 2, dim=(1, 2, 3), keepdim=True)
    return torch.view_as_real(h) / torch.sqrt(energy)[..., None]
