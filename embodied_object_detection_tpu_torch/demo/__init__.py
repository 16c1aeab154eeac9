"""Serving and demos: the streaming predictor (`predictor.py`), the robot
demo (`robot_demo.py`), the image and video demo (`demo.py`), the
cog-style predictor (`predict_api.py`) and the visualizer."""
