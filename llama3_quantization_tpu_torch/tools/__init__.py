"""Tools of the port: the study table's golden rows (`reproduce_study`)."""
