"""Host control plane: native library loaders, phase grids, kernel builds."""
