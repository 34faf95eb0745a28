from .separable import (
    Coeffs1D,
    Coeffs2D,
    dwt1d,
    dwt2d,
    idwt1d,
    idwt2d,
    iswt1d,
    iswt2d,
    iswt2d_denoise,
    swt1d,
    swt2d,
)
from .separable3d import (
    DETAIL_KEYS_3D,
    Coeffs3D,
    dwt3d,
    idwt3d,
    iswt3d,
    iswt3d_denoise,
    swt3d,
)
from .packets import (Packets1D, Packets2D, Packets3D, best_basis,
                      iwp1d, iwp2d, iwp3d, wp1d, wp2d, wp3d, wp_costs,
                      wp_reconstruct)
from .anisotropic import fs_dwt, fs_idwt, fs_slices
from .continuous import (cone_of_influence, cwt, cwt2d,
                         fourier_wavelength, icwt, log_scales)
from .dualtree import (DTCoeffs1D, DTCoeffs2D, dtcwt1d, dtcwt2d,
                       dtcwt_auto_denoise, dtcwt_denoise, dtcwt_wavelets,
                       idtcwt1d, idtcwt2d)
from .starlet import (B3_SPLINE, StarletCoeffs, istarlet, starlet,
                      starlet_denoise)
from .nonseparable import dwt2d_ns, idwt2d_ns, iswt2d_ns, swt2d_ns
from .haar import haar_dwt1d, haar_dwt2d, haar_idwt1d, haar_idwt2d
from .shapes import (coeff_shapes_1d, coeff_shapes_2d, coeff_shapes_3d,
                     div2, level_sizes, max_level)
from .modes import MODES, dec_len, extend, rec_len
from .precision import TIERS
from . import conv, modes, precision

__all__ = [
    "Coeffs1D", "Coeffs2D", "Coeffs3D", "DETAIL_KEYS_3D",
    "dwt1d", "dwt2d", "idwt1d", "idwt2d",
    "dwt3d", "idwt3d", "swt3d", "iswt3d", "iswt3d_denoise",
    "swt1d", "swt2d", "iswt1d", "iswt2d", "iswt2d_denoise",
    "dwt2d_ns", "idwt2d_ns", "swt2d_ns", "iswt2d_ns",
    "Packets1D", "Packets2D", "Packets3D", "wp1d", "wp2d", "wp3d",
    "iwp1d", "iwp2d", "iwp3d",
    "wp_costs", "best_basis", "wp_reconstruct",
    "fs_dwt", "fs_idwt", "fs_slices",
    "cwt", "cwt2d", "icwt", "log_scales", "fourier_wavelength",
    "cone_of_influence",
    "DTCoeffs1D", "DTCoeffs2D", "dtcwt1d", "dtcwt2d", "idtcwt1d",
    "idtcwt2d", "dtcwt_wavelets", "dtcwt_denoise",
    "dtcwt_auto_denoise",
    "B3_SPLINE", "StarletCoeffs", "starlet", "istarlet",
    "starlet_denoise",
    "haar_dwt1d", "haar_dwt2d", "haar_idwt1d", "haar_idwt2d",
    "coeff_shapes_1d", "coeff_shapes_2d", "coeff_shapes_3d",
    "div2", "level_sizes", "max_level",
    "MODES", "dec_len", "rec_len", "extend",
    "TIERS",
    "conv", "modes", "precision",
]
