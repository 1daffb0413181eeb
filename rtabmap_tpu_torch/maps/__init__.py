"""Port of the matching ``rtabmap_tpu`` subpackage."""
