"""Helpers of the port: metrics, atomic snapshot writes, the native JSON scanners."""
