"""The process mesh: the data, frame and spatial axes over processes, one card each (`mesh.py`)."""
