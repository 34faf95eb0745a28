"""Work, reference and control of the ``swt2d_db7_4096`` configuration."""
from bench import control as _control
from bench import reference as _reference


def work(cfg):
    """Bytes and FLOPs of one step, from the shapes alone."""
    return _reference.work2d(cfg)


def reference(cfg, x, *, image=True):
    """The step's answers for input ``x`` in float64 NumPy."""
    return _reference.denoise2d(x, cfg, image=image)


def control(cfg, x, *, image=True):
    """The same at the control's precision (bench/control.py)."""
    return _control.denoise2d(x, cfg, image=image)
