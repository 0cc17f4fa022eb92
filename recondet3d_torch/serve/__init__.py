"""HTTP serving of the DA3 API (port of ``recondet3d/serve``): the model-resident
backend with its web app, the result gallery and the inference client."""
