"""Sensor layer: LiDAR packet decoding (``lidar.py``)."""
