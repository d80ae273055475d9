"""Command-line tools of room_slam_torch (micro-benchmarks)."""
