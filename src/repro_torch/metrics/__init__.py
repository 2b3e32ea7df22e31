"""Distribution-quality metrics of the port."""
