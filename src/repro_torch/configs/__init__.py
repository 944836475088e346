# Configurations of the port: the paper's cascade shape and the pretrained
# synthetic-face cascade (viola_jones.py).
