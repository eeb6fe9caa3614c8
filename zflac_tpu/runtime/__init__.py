"""Runtime: orchestrates host indexing, batched device reconstruction,
and output assembly.

The 24/32-bit sample paths need int64 (the reference's i64 InterType,
zflac.zig:314-319); those reconstruct calls run inside a scoped
`jax.enable_x64(True)` context rather than flipping the global flag,
which would change default dtypes for the embedding application. The hot
16-bit path stays int32 throughout.
"""
