"""Example applications of the port: the ball-pit demo
(``python -m broadphase_tpu_torch.examples.ball_pit``) and the scan-step
visualizer (``python -m broadphase_tpu_torch.examples.scan_visualizer``).
"""
