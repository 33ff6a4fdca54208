"""The port's native host library: C++ voxeliser, counting sort and fused
transform/filter, bound with ctypes (`host.py`)."""
