"""Plain PyTorch references, one module per configuration.

Each module follows the layer equations of the served graph, written out
from the published architecture, and imports nothing of the program.
``layers()`` lists the weighted layers in order (name, kind, shapes);
``forward(params, x)`` maps NHWC f32 images to class probabilities.
"""
