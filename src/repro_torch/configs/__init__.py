"""Architecture configurations the port serves, one module per model."""
