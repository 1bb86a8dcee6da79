"""DPV-SLAM's learned loop closure (numpy): proximity edge proposal."""
