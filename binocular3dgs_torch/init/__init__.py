"""Dense initialization: matching, triangulation and growth of the starting point cloud."""
