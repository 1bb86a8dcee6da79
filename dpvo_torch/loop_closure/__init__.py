"""DPV-SLAM's loop-closure backends: the learned one's proximity edge
proposal (proximity.py), and the classic one (long_term.py: BoW retrieval,
the JPEG image cache, structure-only triangulation, RANSAC-Umeyama and the
Sim3 pose graph)."""
