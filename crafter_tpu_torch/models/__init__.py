from .cnn import CnnPolicy, PolicyOutput
