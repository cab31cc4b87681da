"""Pre/post-processing tax subsystem of the port (counterpart of
``repro.preprocess``): ``host`` NumPy pieces, ``device`` kernels and
PyTorch programs, and :class:`PreprocessStage` behind one
``placement="host"|"device"`` switch."""
from repro_torch.preprocess.stage import (
    DetectPostConfig, NormSpec, PreprocessStage,
)

__all__ = ["DetectPostConfig", "NormSpec", "PreprocessStage"]
