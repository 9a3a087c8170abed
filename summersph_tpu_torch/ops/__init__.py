"""SPH operators: kernels, pair sums, the sorted neighbour structure, the
CUDA pair kernels, EOS, sink gravity, timestep and sinks."""
