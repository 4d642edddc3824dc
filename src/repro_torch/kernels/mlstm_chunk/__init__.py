"""Chunkwise mLSTM: plain version and the Hopper kernel."""
