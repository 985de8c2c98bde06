"""Checkpoints of the port's training state, in the reference's on-disk
format, with HR-layout replica manifests and restore routing."""
