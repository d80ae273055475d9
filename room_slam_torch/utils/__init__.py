"""Utilities of room_slam_torch (the metrics log)."""
