"""Hand-written kernels for the estimator, one: `kernels.compat`.

`degrees_triton` computes the O(N^2) compatibility degrees as a Pallas
kernel through Triton. The estimator runs it when the program is compiled
for a CUDA GPU (engine/sac_cot._degrees) and the XLA loop of
engine/compat.degrees everywhere else. It stays because it beats that loop
end to end on the card (PERF.md); tests run it in Pallas interpret mode.
"""
